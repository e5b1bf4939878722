"""Time the port's default (f32) train step at full width, on one GPU.

    python scripts/time_torch_train_f32.py [--root DIR] [--steps N]

Imports ``vdiff_tpu_torch`` from DIR (default: this checkout), builds its
kernels there, and runs ``train_lib.make_train_step`` as the train CLI runs
it by default: f32, TF32 off, cuDNN's autotuner on (configs/defaults.json),
dropout as configured. cifar10_cond at B=128 and celeba at B=48 (random
weights from a seed, seeded images, labels or tags), one warm-up step and N
timed steps each (CUDA events). Prints the card's name and power limit, then
per model ms a step, img/s and the attention wrappers' launches a step. To
compare two trees, run them in turns in one call (parent, change, change,
parent): ``git archive`` the parent into a directory that .gitignore lists
and pass it as --root. Needs a CUDA device.
"""

import argparse
import copy
import os
import subprocess
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="the tree whose vdiff_tpu_torch to time")
    parser.add_argument("--steps", type=int, default=3, help="timed steps a model")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from vdiff_tpu_torch.factory import CONFIG_DIR, build_diffusion, build_unet, load_experiment_config
    from vdiff_tpu_torch.ops import counted_wrappers
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("time_torch_train_f32: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    wrappers = counted_wrappers()
    for name, B in (("cifar10_cond", 128), ("celeba", 48)):
        cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, f"{name}.json"))
        tr, cond = cfg["train"], cfg["conditional"]
        celeba = name == "celeba"
        model = build_unet(cfg["model"], in_channels=3,
                           model_out_type=cfg["diffusion"]["model_out_type"],
                           num_classes=40 if celeba else 10, multitags=celeba,
                           generator=torch.Generator().manual_seed(0)).cuda()
        ema = copy.deepcopy(model).requires_grad_(False)
        diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                               p_uncond=cond["p_uncond"])
        opt = Optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                        warmup=tr["warmup"], grad_norm=tr["grad_norm"])
        step = make_train_step(model, diffusion, opt, timesteps, use_cfg=cond["use_cfg"],
                               ema_decay=tr["ema_decay"], ema_model=ema)
        gen = torch.Generator().manual_seed(16)
        res = 64 if celeba else 32
        x = (torch.rand(B, res, res, 3, generator=gen) * 2 - 1).cuda()
        y = ((torch.rand(B, 40, generator=gen) < 0.5).float() if celeba else
             torch.randint(0, 10, (B,), generator=gen)).cuda()
        step(x, y, 0, 0).item()  # warm-up: builds the kernels, tunes cuDNN
        for fn in wrappers.values():
            fn.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(1, args.steps + 1):
            loss = step(x, y, 0, i).item()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.steps
        launches = {k: fn.launches // args.steps for k, fn in wrappers.items() if fn.launches}
        print(f"{root} {name} f32 B={B}: {ms:.2f} ms a step, {B * 1e3 / ms:.2f} img/s, loss "
              f"{loss:.6f}, launches a step {launches} ({card})", flush=True)
        del model, ema, opt, step, x, y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
