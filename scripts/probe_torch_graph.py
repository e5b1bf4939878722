"""What one call of the port's graph-replayed sampler pays besides its steps.

    python scripts/probe_torch_graph.py [--config cifar10_cond|celeba] [--reps 3]
        [--out chiprun_out/probe_graph.txt]

Builds the full-width bf16 UNet for ``--config`` (random weights) and times,
on the host clock between synchronisations, whole ``GaussianDiffusion.p_sample``
calls (DDIM, w=0; B=64 for cifar10_cond, 32 for celeba) at T = 1 (the eager
step alone), 2 (plus the capture and one replay), 3 (one replay more) and
256 steps (with the graph only), ``--reps`` times each after a warm-up call,
with the graph and with the eager loop. The capture's cost is then t(2) - t(1) - (t(3) - t(2)).
A second pass runs the same calls with ``torch.cuda.empty_cache`` made a
no-op, which ``torch.cuda.graph`` calls before each capture, to show what
returning the cached blocks to the driver costs the next allocations. The
first lines give the card's name and power limit. Needs a CUDA device.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vdiff_tpu_torch.factory import (CONFIG_DIR, build_diffusion, build_unet,  # noqa: E402
                                     load_experiment_config)
from vdiff_tpu_torch.generate import fused_note  # noqa: E402

# config → (classes, multi-tag, resolution, batch)
SETUPS = {"cifar10_cond": (10, False, 32, 64), "celeba": (40, True, 64, 32)}


def call_ms(diffusion, model, x_T, y, graph):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diffusion.p_sample(model, x_T, label=y, use_ddim=True, graph=graph)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(SETUPS), default="cifar10_cond")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default="probe_graph.txt")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_graph: needs a CUDA device")
    lines = ["card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0],
        fused_note()]
    print("\n".join(lines), flush=True)
    num_classes, multitags, res, batch = SETUPS[args.config]
    cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, f"{args.config}.json"))
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=num_classes, multitags=multitags, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_T = torch.randn(batch, res, res, 3, device="cuda", generator=gen)
    if multitags:
        y = (torch.rand(batch, num_classes, device="cuda", generator=gen) < 0.5).float()
    else:
        y = torch.randint(1, num_classes + 1, (batch,), device="cuda", generator=gen).float()
    empty_cache = torch.cuda.empty_cache
    for keep_cache in (False, True):
        if keep_cache:
            torch.cuda.empty_cache = lambda: None
        for graph in (True, False):
            ms = {}
            for T in (1, 2, 3, 256) if graph else (1, 2, 3):
                diffusion, _ = build_diffusion(cfg["diffusion"], w_guide=0.0, sample_timesteps=T,
                                               continuous_gate=False)
                call_ms(diffusion, model, x_T, y, graph)  # warm-up
                ms[T] = [call_ms(diffusion, model, x_T, y, graph) for _ in range(args.reps)]
            med = {T: statistics.median(v) for T, v in ms.items()}
            step = med[3] - med[2]
            line = (f"{args.config} B={batch} graph={graph} empty_cache="
                    f"{'no-op' if keep_cache else 'torch'}: call ms by T "
                    + ", ".join(f"T={T}: {v}" for T, v in ms.items())
                    + f"; median step t(3)-t(2) {step:.3f} ms"
                    + (f", capture t(2)-t(1)-step {med[2] - med[1] - step:.3f} ms, T=256 call "
                       f"{med[256]:.1f} ms = 256 steps {256 * step:.1f} + {med[256] - 256 * step:.1f}"
                       if graph else ""))
            print(line, flush=True)
            lines.append(line)
    torch.cuda.empty_cache = empty_cache
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
