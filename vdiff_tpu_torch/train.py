"""Training CLI of the port: the root ``train.py``'s flags, plus ``--device``.

    python -m vdiff_tpu_torch.train --config-path vdiff_tpu_torch/configs/synthetic_flagship.json \\
        --allow-bf16 --epochs 1

Each step is loss, backward, global-norm clip, AdamW and EMA on ``--device``
(default ``cuda``; there is no fallback to the CPU, ``--device cpu`` asks for
it). Every ``image_intv`` epochs a sample grid is drawn under the EMA weights,
and every ``ckpt_intv`` epochs (and at the last) a checkpoint
``ckpts/ckpt_{epoch}.pt`` / ``ckpt_last.pt`` is written in the reference
layout, which ``python -m vdiff_tpu_torch.generate --ckpt-path`` samples from.

Flag mapping: ``--allow-bf16`` runs the UNet in bfloat16 (params stay f32),
``--allow-tf32`` lets f32 matmuls and convs use TF32 (off otherwise),
``--cudnn-benchmark`` sets cuDNN's autotuner, ``--allow-fp16`` and
``--use-xformers`` are accepted for parity (the port always runs its own
attention kernels), and ``--prng-impl`` is accepted and ignored (the port draws
from ``torch.Generator``), as are ``--train-device`` and ``--eval-device`` (the
JAX CLI's; ``--device`` places both here). ``--eval`` computes the FID of
10,000 samples against the dataset's precomputed statistics every
``--eval-intv`` epochs (``train_lib.Evaluator``; a conditional model samples
conditionally at w=0, as the root CLI does), and skips it with a message
where the statistics or the Inception weights are missing. ``--remat``
checkpoints the UNet's down and up blocks (their activations recompute in the
backward); ``--remat-policy conv`` does so by itself and keeps the conv, qkv and
attention outputs (``models/remat.py``).

Several GPUs: run under torchrun, one process per GPU,

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m vdiff_tpu_torch.train --distributed --config-path ...

``--distributed`` trains with DDP, ``--fsdp`` shards the parameters, Adam
moments and EMA with FSDP2 over every rank, and ``--fsdp-size k`` over groups
of k ranks (HSDP on the 2-D (data, fsdp) mesh); either implies
``--distributed``. The batch size is the global batch, split over the ranks;
each rank loads its shard of the data, rank 0 alone logs and writes the run
directory (named by its clock), sample grids and checkpoints, which keep
the single-card layout. The run's summary (steps, losses, images/s, peak
device memory, the kernels' launches) is written to ``summary.json`` in the
run directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from datetime import datetime, timezone

import torch

from .data import DATA_INFO, get_dataloader
from .factory import (DEFAULT_CONFIG_PATH, build_diffusion, build_unet, heads_note,
                      load_experiment_config, resolve_section)
from .ops import launch_counts
from .parallel.mesh import broadcast_object, init_distributed, is_leader, sync_global_devices
from .train_lib import Evaluator, Trainer
from .utils.misc import seed_all

# 3-level precedence schema (CLI > experiment JSON > defaults), the root
# train.py's: one row per config field; "op": "OR" marks store_true flags whose
# False falls back to the config, "arg" names the CLI attribute when it differs.
OR = {"op": "OR"}
SCHEMA = {
    "data": {"root": {"arg": "data_root"}},
    "conditional": {"use_cfg": OR, "w_guide": {}, "p_uncond": {}},
    "train": {
        "epochs": {}, "seed": {}, "batch_size": {}, "beta1": {}, "beta2": {},
        "weight_decay": {}, "lr": {}, "grad_norm": {}, "warmup": {},
        "use_ema": OR, "ema_decay": {}, "ckpt_intv": {}, "image_intv": {},
        "num_save_images": {}, "max_ckpts_kept": {},
        # parity no-op: the draws follow from (seed, step)
        "save_rng_state": OR,
    },
    "diffusion": {
        "logsnr_schedule": {}, "logsnr_min": {}, "logsnr_max": {},
        "train_timesteps": {}, "sample_timesteps": {}, "reweight_type": {},
        "model_out_type": {}, "model_var_type": {}, "intp_frac": {},
        "loss_type": {}, "allow_rescale": OR, "x0eps_coef": OR,
    },
    "model": {"use_xformers": OR},
    "speedup": {"cudnn_benchmark": OR, "allow_tf32": OR, "allow_fp16": OR, "allow_bf16": OR},
}

def make_experiment_dirs(exp_dir: str, exp_name: str, distributed: bool = False):
    """The run's directory, named by the clock; with ``distributed``, by rank
    0's on every rank, rank 0 creating it and the others waiting at a
    barrier until it exists."""
    timestamp = datetime.now(tz=timezone.utc).strftime("%Y-%m-%dT%H%M%S%f")
    if distributed:
        timestamp = broadcast_object(timestamp)
    exp_dir = os.path.join(exp_dir, f"dpm_{exp_name}", timestamp)
    ckpt_dir = os.path.join(exp_dir, "ckpts")
    image_dir = os.path.join(exp_dir, "images")
    if not distributed or is_leader():
        os.makedirs(image_dir, exist_ok=True)
        os.makedirs(ckpt_dir, exist_ok=True)
    if distributed:
        sync_global_devices("experiment_dirs")
    return exp_dir, ckpt_dir, image_dir


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the run's directories and the
    trainer's summary (steps, loss, images/s after the first step)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    fsdp = args.fsdp or args.fsdp_size > 1
    distributed = args.distributed or fsdp
    if distributed:
        flag = "--fsdp-size" if args.fsdp_size > 1 else "--fsdp" if args.fsdp else "--distributed"
        device = init_distributed(device, flag=flag)
    leader = not distributed or is_leader()  # rank 0 logs and writes
    log = print if leader else (lambda *a, **k: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    config, default_name = load_experiment_config(args.config_path, args.default_config_path)
    exp_name = args.exp_name or default_name
    r = {s: resolve_section(config, args, s, fields) for s, fields in SCHEMA.items()}
    data, cond, train, speedup = r["data"], r["conditional"], r["train"], r["speedup"]

    dataset = config["data"]["name"]
    root = os.path.expandvars(os.path.expanduser(data.root))
    info = DATA_INFO[dataset]
    image_shape = info["resolution"] + (info["channels"],)  # NHWC
    num_classes = info.get("num_classes", 0) if cond.use_cfg else 0

    seed_all(train.seed)
    torch.backends.cuda.matmul.allow_tf32 = bool(speedup.allow_tf32)
    torch.backends.cudnn.allow_tf32 = bool(speedup.allow_tf32)
    torch.backends.cudnn.benchmark = bool(speedup.cudnn_benchmark)
    dtype = torch.bfloat16 if speedup.allow_bf16 else torch.float32
    log(f"bf16 compute: {'ON' if speedup.allow_bf16 else 'OFF'}; "
        f"TF32: {'ON' if speedup.allow_tf32 else 'OFF'}; device: {device}")
    if distributed:
        mode = (f"FSDP over groups of {args.fsdp_size} (HSDP)" if args.fsdp_size > 1
                else "FSDP" if fsdp else "DDP")
        log(f"parallel: {mode}, {torch.distributed.get_world_size()} ranks "
            f"({torch.distributed.get_backend()})")

    diffusion, train_timesteps = build_diffusion(config["diffusion"], w_guide=cond.w_guide,
                                                 p_uncond=cond.p_uncond)
    model = build_unet(config["model"], in_channels=info["channels"],
                       model_out_type=config["diffusion"]["model_out_type"],
                       num_classes=num_classes, multitags=info.get("multitags", False),
                       dtype=dtype, generator=torch.Generator().manual_seed(train.seed),
                       model_var_type=config["diffusion"]["model_var_type"],
                       remat=args.remat, remat_policy=args.remat_policy)
    if model.remat:
        log(f"remat: the down and up blocks recompute in the backward (policy "
            f"{model.remat_policy or 'none: nothing saved inside a block'})")
    if heads_note(config["model"]):
        log(heads_note(config["model"]))
    trainloader, _ = get_dataloader(dataset, batch_size=train.batch_size,
                                    split="all" if dataset == "celeba" else "train",
                                    random_seed=train.seed, root=root, drop_last=True,
                                    distributed=distributed, num_workers=args.num_workers)

    exp_dir, ckpt_dir, image_dir = make_experiment_dirs(args.exp_dir, exp_name, distributed)
    log(f"Checkpoints → {os.path.abspath(ckpt_dir)} every {train.ckpt_intv} epoch(s)")
    log(f"Images (x{train.num_save_images}) → {os.path.abspath(image_dir)} "
        f"every {train.image_intv} epoch(s)")

    trainer = Trainer(
        model=model, diffusion=diffusion, timesteps=train_timesteps, epochs=train.epochs,
        trainloader=trainloader,
        optimizer_config=dict(lr=train.lr, beta1=train.beta1, beta2=train.beta2,
                              weight_decay=train.weight_decay, warmup=train.warmup),
        use_cfg=cond.use_cfg, use_ema=train.use_ema, grad_norm=train.grad_norm,
        num_accum=args.num_accum, shape=image_shape, ckpt_intv=train.ckpt_intv,
        max_ckpts_kept=train.max_ckpts_kept, image_intv=train.image_intv,
        num_save_images=train.num_save_images, ema_decay=train.ema_decay, seed=train.seed,
        eval_intv=args.eval_intv, device=device, distributed=distributed, fsdp=args.fsdp,
        fsdp_size=args.fsdp_size,
    )
    evaluator = None
    if args.eval:
        # the headline FID's condition: class-conditional sampling at w=0, so
        # a CFG model's evaluation skips the doubled batch; the trainer draws
        # the labels
        # on several ranks each runs its slice of every Inception batch
        on_mesh = {} if trainer.mesh is None else {"mesh": trainer.mesh}
        evaluator = Evaluator(dataset=dataset, device=device,
                              diffusion=dataclasses.replace(diffusion, w_guide=0.0)
                              if cond.use_cfg else None, **on_mesh)
    if args.resume:
        try:
            trainer.load_checkpoint(ckpt_path=args.from_ckpt, ckpt_dir=ckpt_dir)
            log("Successfully loaded checkpoint!")
        except FileNotFoundError:
            log("Checkpoint file does not exist!\nStarting from scratch...")

    if leader:
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            config["args"] = vars(args)
            json.dump(config, f, indent=2)

    log("Training starts...", flush=True)
    before = launch_counts()
    summary = trainer.train(ckpt_dir=ckpt_dir, image_dir=image_dir, use_ddim=args.use_ddim,
                            evaluator=evaluator)
    summary = {"exp_dir": exp_dir, "ckpt_dir": ckpt_dir, "image_dir": image_dir, **summary,
               "world_size": trainer.world,
               "peak_bytes": torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else None,
               "launches": {k: n - before[k] for k, n in launch_counts().items()}}
    if leader:  # what a launcher reads back of a torchrun run
        with open(os.path.join(exp_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_root", type=str, help="root directory of datasets")
    p.add_argument("--epochs", type=int, help="total number of training epochs")
    p.add_argument("--lr", type=float, help="learning rate")
    p.add_argument("--beta1", type=float, help="beta_1 in Adam")
    p.add_argument("--beta2", type=float, help="beta_2 in Adam")
    p.add_argument("--weight-decay", type=float, help="decoupled weight_decay factor in Adam")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--num-accum", type=int, default=1,
                   help="number of micro-batches per weight update (gradient accumulation)")
    p.add_argument("--train-timesteps", type=int,
                   help="number of diffusion steps for training (0 indicates continuous training)")
    p.add_argument("--sample-timesteps", type=int, help="number of diffusion steps for sampling")
    p.add_argument("--logsnr-schedule", choices=["linear", "sigmoid", "cosine", "legacy"])
    p.add_argument("--logsnr-max", type=float)
    p.add_argument("--logsnr-min", type=float)
    p.add_argument("--model-out-type", type=str, choices=["x_0", "x0", "eps", "both", "v"])
    p.add_argument("--model-var-type", type=str, choices=["fixed_small", "fixed_large", "fixed_medium"])
    p.add_argument("--reweight-type", type=str, choices=["constant", "snr", "snr_trunc", "snr_1plus"])
    p.add_argument("--loss-type", type=str, choices=["kl", "mse"])
    p.add_argument("--intp-frac", type=float)
    p.add_argument("--w-guide", type=float, help="classifier-free guidance strength")
    p.add_argument("--p-uncond", type=float, help="probability of unconditional training")
    p.add_argument("--num-workers", type=int, default=4,
                   help="CelebA's JPEG decode threads (other datasets are in memory)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--train-device", type=str, default="cuda",
                   help="(parity) accepted and ignored: --device places training")
    p.add_argument("--eval-device", type=str, default="cuda",
                   help="(parity) accepted and ignored: --device places sampling")
    p.add_argument("--image-intv", type=int)
    p.add_argument("--num-save-images", type=int, help="number of images to generate & save")
    p.add_argument("--use-ddim", action="store_true", help="whether to use DDIM sampler")
    p.add_argument("--config-path", required=True, type=str)
    p.add_argument("--default-config-path", default=DEFAULT_CONFIG_PATH, type=str)
    p.add_argument("--exp-dir", type=str, default="./exps")
    p.add_argument("--exp-name", type=str)
    p.add_argument("--ckpt-intv", type=int, help="frequency of saving a checkpoint")
    p.add_argument("--save-rng-state", action="store_true",
                   help="(parity) the draws follow from (seed, step)")
    p.add_argument("--seed", type=int, help="random seed")
    p.add_argument("--resume", action="store_true", help="to resume training from a checkpoint")
    p.add_argument("--from-ckpt", type=str, help="from which checkpoint to resume")
    p.add_argument("--eval", action="store_true", help="whether to evaluate fid during training")
    p.add_argument("--eval-intv", type=int, default=128, help="frequency of evaluating the model")
    p.add_argument("--ema-decay", type=float, help="decay factor of ema")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training (DDP) over torchrun's ranks, one per GPU")
    p.add_argument("--cudnn-benchmark", action="store_true", help="cuDNN autotuner")
    p.add_argument("--allow-tf32", action="store_true", help="TF32 in f32 matmuls and convs")
    p.add_argument("--allow-fp16", action="store_true", help="(parity) see --allow-bf16")
    p.add_argument("--allow-bf16", action="store_true", help="bfloat16 compute in the UNet")
    p.add_argument("--use-xformers", action="store_true",
                   help="(parity) the port always runs its attention kernels")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters, Adam moments and EMA over every rank (FSDP2); "
                        "implies --distributed")
    p.add_argument("--fsdp-size", type=int, default=0,
                   help="shard the state within groups of this many ranks and replicate across "
                        "groups (HSDP, a 2-D (data, fsdp) mesh); implies --distributed")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing of the UNet's down and up blocks: their "
                        "activations recompute in the backward")
    p.add_argument("--remat-policy", type=str, default=None, choices=["conv"],
                   help="selective remat: keep the conv, qkv and attention outputs, recompute "
                        "the elementwise chains between them and the attention forward; enables "
                        "checkpointing by itself")
    p.add_argument("--prng-impl", type=str, default="rbg", choices=["rbg", "threefry2x32"],
                   help="(parity) accepted and ignored: the port draws from torch.Generator")
    p.add_argument("--max-ckpts-kept", type=int,
                   help="maximum number of checkpoints to keep on disk (-1 for no cap)")
    p.add_argument("--use-cfg", action="store_true", help="whether to use classifier-free guidance")
    p.add_argument("--use-ema", action="store_true", help="whether to use exponential moving average")
    p.add_argument("--allow-rescale", action="store_true",
                   help="whether to adjust t per the schedule remap")
    p.add_argument("--x0eps-coef", action="store_true",
                   help="whether the posterior mean should be expressed in terms of x0 and eps")
    return p


if __name__ == "__main__":
    main()
