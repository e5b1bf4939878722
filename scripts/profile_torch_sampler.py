"""Where the port's sampling step spends its time on the GPU.

    python scripts/profile_torch_sampler.py [--config cifar10_cond|celeba] [--steps 4]
        [--fused] [--graph] [--out profile_sampler.txt]

Builds the full-width UNet of ``vdiff_tpu_torch`` for ``--config`` (random
weights), then for its sampling cells of the JAX bench — cifar10_cond: DDIM
w=0 at B=64 and CFG w=0.1 at B=32; celeba: DDIM w=0 at B=32 with multi-hot
tags (bench.py:336-346) — in bf16 activations, runs a few warm-up steps and
then ``--steps`` reverse steps under ``torch.profiler``. Prints per cell the step
time (host clock around synchronised steps), the device-busy share (summed
kernel time over wall time) and the kernels by total device time; the full
tables go to ``--out``. ``--fused`` sets ``VDIFF_FUSED_CONV=1`` and
``VDIFF_FUSED_GN=1`` first, so the same profile comes back for the fused
inference kernels (set ``VDIFF_FUSED_GN=1`` alone in the environment for the
one-kernel GroupNorm without the fused conv); ``--graph`` profiles the
steps as the sampler runs them on CUDA, each a replay of one CUDA graph of
the step (``diffusion.StaticStep``, captured after the first warm-up step).
The first lines printed give the card's name and power limit and say which
switches were on. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vdiff_tpu_torch.diffusion import StaticStep  # noqa: E402
from vdiff_tpu_torch.factory import (CONFIG_DIR, build_diffusion, build_unet,  # noqa: E402
                                     load_experiment_config)
from vdiff_tpu_torch.generate import fused_note  # noqa: E402
from vdiff_tpu_torch.utils.profiling import device_us  # noqa: E402

# config → (classes, multi-tag, resolution, cells as (name, w, batch))
SETUPS = {
    "cifar10_cond": (10, False, 32, (("ddim w=0 B=64", 0.0, 64), ("cfg w=0.1 B=32", 0.1, 32))),
    "celeba": (40, True, 64, (("ddim w=0 B=32", 0.0, 32),)),
}


def profile_cell(model, cfg, w_guide, batch, steps, num_classes, multitags, res, graph=False,
                 warmup=3):
    diffusion, _ = build_diffusion(cfg["diffusion"], w_guide=w_guide, sample_timesteps=256,
                                   continuous_gate=False)
    tables = {k: torch.as_tensor(v, device="cuda")
              for k, v in diffusion.sample_tables(use_ddim=True).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, res, res, 3, device="cuda", generator=gen)
    if multitags:
        y = (torch.rand(batch, num_classes, device="cuda", generator=gen) < 0.5).float()
    else:
        y = torch.randint(1, num_classes + 1, (batch,), device="cuda", generator=gen).float()

    def step(i, x):
        row = {k: v[i] for k, v in tables.items()}
        return diffusion._p_sample_step(model, x, row, y, None, use_ddim=True)[0]

    if graph:  # as GaussianDiffusion._graph_steps runs them: x advances in place
        static = StaticStep(diffusion, model, x, y, diffusion.sample_tables(use_ddim=True), True,
                            {"clip_denoised": True, "use_ddim": True})
        side, replay = torch.cuda.Stream(), torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode(), torch.cuda.stream(side):
            static()
        torch.cuda.current_stream().wait_stream(side)
        with torch.inference_mode(), torch.cuda.graph(replay, stream=side):
            static()

        def step(i, x):
            replay.replay()
            return x

    with torch.inference_mode():
        for i in range(warmup):
            x = step(i, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(warmup, warmup + steps):
                x = step(i, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the same window again without the profiler, for the step time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(warmup + steps, warmup + 2 * steps):
            x = step(i, x)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
    events = prof.key_averages()
    busy_us = sum(device_us(e) for e in events)
    return step_ms, busy_us / (wall * 1e6), busy_us / steps / 1e3, events


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(SETUPS), default="cifar10_cond")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--fused", action="store_true",
                   help="set VDIFF_FUSED_CONV=1 and VDIFF_FUSED_GN=1 for this run")
    p.add_argument("--graph", action="store_true",
                   help="profile replays of the step's CUDA graph, as the sampler runs on CUDA")
    p.add_argument("--out", default="profile_sampler.txt")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sampler: needs a CUDA device")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    if args.fused:
        os.environ["VDIFF_FUSED_CONV"] = os.environ["VDIFF_FUSED_GN"] = "1"
    print(fused_note())
    num_classes, multitags, res, cells = SETUPS[args.config]
    cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, f"{args.config}.json"))
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=num_classes, multitags=multitags, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda().eval()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(fused_note() + "\n")
        for name, w, batch in cells:
            step_ms, busy, kernel_ms, events = profile_cell(model, cfg, w, batch, args.steps,
                                                            num_classes, multitags, res, args.graph)
            head = (f"{args.config} {name}{' (graph)' if args.graph else ''}: {step_ms:.3f} ms/step ({batch * 1e3 / step_ms / 256:.3f} samples/s "
                    f"at 256 steps), device busy {busy:.3f} of the profiled wall time, "
                    f"kernel time {kernel_ms:.3f} ms/step")
            print(head)
            top = sorted((e for e in events if device_us(e) > 0), key=device_us, reverse=True)
            for e in top[:12]:
                print(f"  {device_us(e) / args.steps / 1e3:8.3f} ms/step  {e.count // args.steps:5d}x/step"
                      f"  {e.key[:90]}")
            f.write(head + "\n")
            key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
                else "self_cuda_time_total"
            f.write(events.table(sort_by=key, row_limit=60) + "\n\n")


if __name__ == "__main__":
    main()
