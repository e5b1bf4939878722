"""Quality gate of the port: one command that runs train → generate → eval
through the port's real CLIs, the counterpart of the JAX package's
``scripts/quality_gate.py`` with the same flags, defaults and stage order
(``--device`` in place of ``--platform``, as in the port's other CLIs).

    python -m vdiff_tpu_torch.quality_gate --device cpu

runs the whole chain on the CPU with the synthetic dataset and the tiny
synthetic_smoke model: ``python -m vdiff_tpu_torch.train`` writes its
checkpoints, ``python -m vdiff_tpu_torch.generate`` samples from the newest,
``python -m vdiff_tpu_torch.eval`` scores the images (and, for ``nll``, the
checkpoint). Metrics whose weights or statistics are absent (the FID
Inception, VGG16, the TTUR npz; WEIGHTS.md) are skipped by the eval CLI and
reported as such. Without ``--device`` every stage asks for CUDA.

On the day the weights and data arrive the real gate is argument-only:

    python -m vdiff_tpu_torch.quality_gate \\
        --config vdiff_tpu_torch/configs/cifar10_cond.json --dataset cifar10 \\
        --data-root ~/datasets --precomputed-dir ./precomputed \\
        --epochs 2160 --total-size 50000 --sample-timesteps 256 \\
        --batch-size 128 --metrics fid is pr

with ``precomputed/`` holding the TTUR ``fid_stats_cifar10_train.npz`` and the
release weights ``metrics/inception.py`` and ``metrics/vgg.py`` look for.
Target: FID 2.58 / IS 9.76 at w=0 (reference README.md:118).

Each stage is a subprocess of this interpreter, run in this process's
working directory (where ``./precomputed`` and the other relative paths are
read) with the repository root on ``PYTHONPATH``; a relative ``--config``
that does not exist there is read from the repository root. A stage that
exits non-zero ends the gate with its exit code and a line naming it.
``--dp`` runs the generate and eval stages under ``python -m
torch.distributed.run --standalone``, one rank per GPU (``--device cuda``)
or one rank (``--device cpu``). The last line is
``{"quality_gate": "ok", "checkpoint": ..., "images": ...}``. This module
imports nothing of torch or JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_stage(name, argv, dp=False, device="cuda"):
    """``python -m <argv>`` (under torchrun with ``dp``); exits the gate with
    the stage's code unless it exits 0, else prints its seconds."""
    launcher = []
    if dp:
        launcher = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "gpu" if device.startswith("cuda") else "1"]
    cmd = [sys.executable] + launcher + ["-m"] + argv
    print(f"\n=== {name}: {' '.join(cmd[1:])}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env)
    if proc.returncode != 0:
        print(f"quality gate FAILED at stage '{name}' (exit {proc.returncode})", flush=True)
        sys.exit(proc.returncode)
    print(f"--- {name}: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)


def _ckpt_tag(name):
    """The tag of a checkpoint file (``ckpt_12.pt`` → "12"), or None for
    anything else, such as an interrupted save's temporary file: the rule of
    ``train_lib._ckpt_tag``, repeated so that this module imports no torch."""
    if not (name.startswith("ckpt_") and name.endswith(".pt")):
        return None
    tag = name[len("ckpt_"):-len(".pt")]
    return tag if tag.isdigit() or tag in ("last", "latest") else None


def latest_ckpt(exp_root):
    """The newest run's newest checkpoint under exps/dpm_<name>/<timestamp>/ckpts:
    the newest run directory by mtime, then ``ckpt_last``/``ckpt_latest``, else
    the highest epoch, as ``CheckpointManager.latest_path`` picks."""
    runs = [os.path.join(exp_root, d) for d in
            (os.listdir(exp_root) if os.path.isdir(exp_root) else [])]
    if not runs:
        raise FileNotFoundError(f"no runs under {exp_root}")
    ckpt_dir = os.path.join(max(runs, key=os.path.getmtime), "ckpts")
    cands = [d for d in (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else [])
             if _ckpt_tag(d) is not None]
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")

    def key(d):
        tag = _ckpt_tag(d)
        return (1, 0) if tag in ("last", "latest") else (0, int(tag))

    return os.path.join(ckpt_dir, max(cands, key=key))


def newest_png_dir(img_dir):
    """The newest directory under ``img_dir`` that holds PNGs, by mtime:
    this run's images, not an earlier run's (``img_dir`` if none does)."""
    png_dirs = [root for root, _, files in os.walk(img_dir)
                if any(f.endswith(".png") for f in files)]
    return max(png_dirs, key=os.path.getmtime) if png_dirs else img_dir


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="vdiff_tpu_torch/configs/synthetic_smoke.json")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data-root", default="~/datasets")
    p.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "vdiff_quality_gate"))
    p.add_argument("--precomputed-dir", default="./precomputed")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--total-size", type=int, default=16, help="images to generate")
    p.add_argument("--sample-timesteps", type=int, default=4)
    p.add_argument("--eval-total-size", type=int, default=16)
    p.add_argument("--eval-batch-size", type=int, default=16)
    p.add_argument("--metrics", nargs="+", default=["fid", "is", "pr", "nll"])
    p.add_argument("--w-guide", type=float, default=0.0, help="0 = FID-2.58 headline condition")
    p.add_argument("--skip-train", action="store_true", help="reuse the newest existing run")
    p.add_argument("--ckpt-path", default="", help="explicit checkpoint (implies --skip-train)")
    p.add_argument("--use-ema", action="store_true", default=True)
    p.add_argument("--dp", action="store_true",
                   help="shard bulk sampling and the metric batches over all GPUs (torchrun)")
    p.add_argument("--device", default="cuda",
                   help="every stage's device (cpu to verify the chain without a GPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = args.config
    if not os.path.isabs(config) and not os.path.exists(config):
        config = os.path.join(REPO, config)
    device = ["--device", args.device]

    exp_dir = os.path.join(args.work_dir, "exps")
    img_dir = os.path.join(args.work_dir, "images")
    os.makedirs(args.work_dir, exist_ok=True)

    # 1) train: writes the config dump, checkpoints and sample grids
    if not (args.skip_train or args.ckpt_path):
        run_stage("train", [
            "vdiff_tpu_torch.train", "--config-path", config, "--exp-dir", exp_dir,
            "--data_root", args.data_root, "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size), "--use-ema", "--use-ddim", *device,
        ])

    exp_name = os.path.splitext(os.path.basename(config))[0]
    ckpt = args.ckpt_path or latest_ckpt(os.path.join(exp_dir, f"dpm_{exp_name}"))
    print(f"\ncheckpoint: {ckpt}", flush=True)

    # 2) generate: bulk sampling from that checkpoint
    gen_args = [
        "vdiff_tpu_torch.generate", "--config-path", config, "--ckpt-path", ckpt,
        "--save-dir", img_dir, "--total-size", str(args.total_size),
        "--batch-size", str(min(args.batch_size, args.total_size)),
        "--sample-timesteps", str(args.sample_timesteps), "--use-ddim",
        "--w-guide", str(args.w_guide), "--data-root", args.data_root, *device,
    ]
    if args.use_ema:
        gen_args.append("--use-ema")
    if args.dp:
        gen_args.append("--dp")
    run_stage("generate", gen_args, args.dp, args.device)

    # generate nests the images under save_dir/<config>/<timestamp>/
    img_root = newest_png_dir(img_dir)

    # 3) eval: FID / IS / P&R over that directory (and nll of the checkpoint);
    # a metric without its local weights is skipped by the CLI, not fatal
    eval_args = [
        "vdiff_tpu_torch.eval", "--dataset", args.dataset, "--root", args.data_root,
        "--eval-dir", img_root, "--precomputed-dir", args.precomputed_dir,
        "--eval-total-size", str(args.eval_total_size),
        "--eval-batch-size", str(args.eval_batch_size),
        "--metrics", *args.metrics, "--config-path", config, "--ckpt-path", ckpt, *device,
    ]
    if args.use_ema and "nll" in args.metrics:
        eval_args.append("--use-ema")
    if args.dp:
        eval_args.append("--dp")
    run_stage("eval", eval_args, args.dp, args.device)

    print(json.dumps({"quality_gate": "ok", "checkpoint": ckpt, "images": img_root}))


if __name__ == "__main__":
    main()
