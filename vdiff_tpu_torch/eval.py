"""Offline metrics CLI of the port: the root ``eval.py``'s flags, plus
``--device``.

    python -m vdiff_tpu_torch.eval --dataset cifar10 --eval-dir ./images/eval \\
        --metrics fid is pr
    python -m vdiff_tpu_torch.eval --dataset cifar10 --metrics nll \\
        --config-path vdiff_tpu_torch/configs/cifar10_cond.json --ckpt-path model.pt

Metrics over a folder of generated images: ``fid`` (FID InceptionV3 features
against the dataset's precomputed statistics), ``is`` (the Inception Score,
mean ± std over ``--is-splits``) and ``pr`` (improved precision/recall on
VGG16 features against the real data's manifold, cached as
``pr_manifold_<dataset>_<split>.npz`` in ``--precomputed-dir``); and ``nll``,
the test split's bits/dim through the full per-step variational bound
(``GaussianDiffusion.calc_all_bpd``) of a reference-format ``.pt``
checkpoint, its UNet in float32. Every network runs on ``--device`` (default
``cuda``; there is no fallback to the CPU, ``--device cpu`` asks for it),
in float32 with TF32 off. A metric whose weights or statistics are missing
is skipped with a message, as the root CLI skips it. ``--model-device``,
``--eval-device`` and ``--num-workers`` are accepted for parity and ignored.

``--dp`` runs under torchrun, one rank per GPU
(``python -m torch.distributed.run --standalone --nproc_per_node=N -m
vdiff_tpu_torch.eval --dp ...``): every rank reads every batch, runs its
slice of each Inception, VGG16, distance or nll batch, and the slices are
all-gathered; FID, IS and P&R are computed on rank 0 and broadcast, and rank
0 prints. The nll batch must divide by the world size, as the root CLI's
``--dp`` requires.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .metrics.device_apply import resolve_eval_mesh
from .parallel.mesh import all_gather_rows, is_leader, leader_value, row_range


def iter_image_batches(folder, total_size, batch_size, rng):
    """Uniformly subsample the folder to total_size and yield uint8 batches."""
    indices = np.arange(len(folder))
    if len(folder) > total_size:
        indices = rng.choice(len(folder), size=total_size, replace=False)
    for s in range(0, len(indices), batch_size):
        yield folder.load_batch(indices[s:s + batch_size])


def _to_unit(im):
    return (im.astype(np.float32) - 127.5) / 127.5


def compute_fid(batches, dataset, precomputed_dir, device="cuda", mesh=None):
    from .metrics import InceptionStatistics, calc_fd, get_precomputed

    istats = InceptionStatistics(input_transform=_to_unit, device=device, mesh=mesh)
    true_mean, true_var = get_precomputed(dataset, download_dir=precomputed_dir)
    for x in batches:
        istats(x)
    gen_mean, gen_var = istats.get_statistics()
    return leader_value(lambda: calc_fd(gen_mean, gen_var, true_mean, true_var), mesh)


def compute_is(batches, splits, device="cuda", mesh=None):
    """The Inception Score of the generated images, "mean +/- std"."""
    from .metrics.inception_score import InceptionScoreStatistics

    stats = InceptionScoreStatistics(input_transform=_to_unit, splits=splits, device=device,
                                     mesh=mesh)
    for x in batches:
        stats(x)
    mean, std = leader_value(stats.get_statistics, mesh)
    return f"{mean:.4f} +/- {std:.4f}"


def load_true_manifold(builder, dataset, root, precomputed_dir):
    """The real data's P&R manifold, cached as an npz beside the FID
    statistics: celeba's whole 202,599-image split, the train split of the
    others (the split is part of the file name)."""
    from .data import _build_dataset
    from .metrics.precision_recall import Manifold

    split = "all" if dataset == "celeba" else "train"
    path = os.path.join(precomputed_dir, f"pr_manifold_{dataset}_{split}.npz")
    if os.path.exists(path):
        d = np.load(path)
        return Manifold(d["features"], d["kth"])
    manifold = builder(data=_build_dataset(dataset, root, split)).manifold
    if is_leader():
        os.makedirs(precomputed_dir, exist_ok=True)
        np.savez(path, features=manifold.features, kth=manifold.kth)
    return manifold


def compute_pr(folder, args, dataset, root, device="cuda", mesh=None):
    from functools import partial

    from .metrics.precision_recall import ManifoldBuilder, calc_pr

    builder = partial(ManifoldBuilder, extr_batch_size=args.eval_batch_size,
                      max_sample_size=args.eval_total_size, row_batch_size=args.row_batch_size,
                      col_batch_size=args.col_batch_size, nhood_size=args.nhood_size,
                      device=device, mesh=mesh)
    true_manifold = load_true_manifold(builder, dataset, root, args.precomputed_dir)
    gen_manifold = builder(data=folder).manifold
    precision, recall = calc_pr(gen_manifold, true_manifold, row_batch_size=args.row_batch_size,
                                col_batch_size=args.col_batch_size, device=device, mesh=mesh)
    decimal_places = math.ceil(math.log(args.eval_total_size, 10))
    return f"{precision:.{decimal_places}f}/{recall:.{decimal_places}f}"


def nll_generator(seed: int, start: int, device) -> torch.Generator:
    """The generator of one nll batch's noise, a function of (seed, the
    batch's first index) only."""
    state = np.random.SeedSequence([seed, start]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def compute_nll(args, dataset, root, device="cuda", mesh=None):
    """The test split's bits/dim (celeba: all of it), ``--eval-batch-size``
    images a batch, the tail shorter than a batch dropped (said so). A
    conditional checkpoint (one with ``class_embed``) gets the labels. With a
    data ``mesh`` each rank computes the bits/dim of its contiguous rows of
    every batch, from the whole batch's noise, and the rows are gathered, so
    the number is the one-rank run's."""
    from .data import DATA_INFO, _build_dataset, normalize_flip
    from .factory import (build_diffusion, build_unet, load_checkpoint_params,
                          load_experiment_config, load_weights)

    if not (args.config_path and args.ckpt_path):
        return "nll requires --config-path and --ckpt-path"

    state_dict, head_keys = load_checkpoint_params(args.ckpt_path, use_ema=args.use_ema)
    use_cfg = "class_embed" in head_keys
    config, _ = load_experiment_config(args.config_path)
    info = DATA_INFO[dataset]
    diffusion, _ = build_diffusion(config["diffusion"], w_guide=0.0, continuous_gate=False)
    model = build_unet(config["model"], in_channels=info["channels"],
                       model_out_type=config["diffusion"]["model_out_type"],
                       num_classes=info.get("num_classes", 0) if use_cfg else 0,
                       multitags=info.get("multitags", False) if use_cfg else False,
                       model_var_type=config["diffusion"]["model_var_type"])
    load_weights(model, state_dict)
    model = model.to(device).eval()

    split = "test" if dataset != "celeba" else "all"
    ds = _build_dataset(dataset, root, split)
    n = min(len(ds), args.eval_total_size)
    if n <= 0:
        return "no samples to evaluate (empty split or --eval-total-size 0)"
    B = min(args.eval_batch_size, n)  # small datasets: one full-sized batch at most
    start, stop, rows = 0, B, None
    if mesh is not None:
        if B % mesh.size():
            raise SystemExit(f"--dp needs the effective nll batch ({B}) divisible by "
                             f"{mesh.size()} ranks")
        start, stop = row_range(B)
        rows = (start, B)
    totals = []
    for s in range(0, n - B + 1, B):
        idx = np.arange(s + start, s + stop)
        raw = ds.load_batch(idx) if hasattr(ds, "load_batch") else ds.images[idx]
        x = torch.from_numpy(normalize_flip(np.ascontiguousarray(raw))).to(device)
        y = torch.as_tensor(np.asarray(ds.targets)[idx], dtype=torch.float32,
                            device=device) if use_cfg else None
        total_bpd, _, _, _ = diffusion.calc_all_bpd(model, x, y,
                                                    generator=nll_generator(args.seed, s, device),
                                                    batch_rows=rows)
        if mesh is not None:
            total_bpd = all_gather_rows(total_bpd)
        totals.append(total_bpd.cpu().numpy())
    used = len(totals) * B
    if used < n and (mesh is None or is_leader()):
        print(f"nll computed over {used}/{n} samples (tail < batch size dropped)")
    return float(np.concatenate(totals).mean())


def _compute_metric(metric, args, dataset, root, img_dir, device, mesh=None):
    from .data import ImageFolder

    if metric == "nll":
        return compute_nll(args, dataset, root, device, mesh)
    if metric not in ("fid", "is", "pr"):
        return None
    folder = ImageFolder(img_dir)
    if len(folder) == 0:
        raise FileNotFoundError(f"no images found under '{img_dir}'")
    if metric == "pr":
        return compute_pr(folder, args, dataset, root, device, mesh)
    batches = iter_image_batches(folder, args.eval_total_size, args.eval_batch_size, np.random)
    if metric == "fid":
        return compute_fid(batches, dataset, args.precomputed_dir, device, mesh)
    return compute_is(batches, args.is_splits, device, mesh)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns {metric: result} of the metrics that
    ran (a skipped or unsupported one is left out). Where the image folder
    exists, rank 0 also writes ``eval_summary.json`` there: the results, the
    seconds the metrics took (in all and each) and the kernels' launches (the
    nll UNet's)."""
    from .ops import launch_counts
    from .utils.misc import seed_all

    args = build_parser().parse_args(argv)
    mesh, device = resolve_eval_mesh(args.dp, args.device)
    log = print if mesh is None or is_leader() else (lambda *a, **k: None)  # rank 0 prints
    # f32 means f32: no TF32 in the metric nets' convs and matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seed_all(args.seed)
    root = os.path.expanduser(args.root)
    dataset = args.dataset
    log(f"Dataset: {dataset}")
    img_dir = os.path.join(args.eval_dir, args.folder_name) if args.folder_name else args.eval_dir

    results, metric_seconds, before, t0 = {}, {}, launch_counts(), time.perf_counter()
    for metric in sorted(set(args.metrics)):
        t_metric = time.perf_counter()
        try:
            result = _compute_metric(metric, args, dataset, root, img_dir, device, mesh)
        except FileNotFoundError as e:
            # metric weights and statistics are local files: a missing one
            # skips its metric instead of ending the run
            log(f"{metric.upper()} skipped: {e}")
            continue
        if result is None:
            log(f"Unsupported metric {metric!r}! Ignore.")
            continue
        log(f"{metric.upper()}: {result}", flush=True)
        results[metric] = result
        metric_seconds[metric] = time.perf_counter() - t_metric
    if (mesh is None or is_leader()) and os.path.isdir(img_dir):  # what a launcher reads back
        summary = {"results": results, "seconds": time.perf_counter() - t0,
                   "metric_seconds": metric_seconds,
                   "launches": {k: n - before[k] for k, n in launch_counts().items()}}
        with open(os.path.join(img_dir, "eval_summary.json"), "w") as f:
            json.dump(summary, f)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default="~/datasets", type=str)
    p.add_argument("--dataset", choices=["mnist", "cifar10", "celeba", "synthetic"],
                   default="cifar10")
    p.add_argument("--model-device", default=0, type=int,
                   help="(parity) accepted and ignored: --device places the networks")
    p.add_argument("--eval-device", default=0, type=int,
                   help="(parity) accepted and ignored: --device places the networks")
    p.add_argument("--eval-batch-size", default=512, type=int)
    p.add_argument("--eval-total-size", default=50000, type=int)
    p.add_argument("--num-workers", default=4, type=int,
                   help="(parity) accepted and ignored: images decode batch by batch")
    p.add_argument("--nhood-size", default=3, type=int)
    p.add_argument("--row-batch-size", default=10000, type=int)
    p.add_argument("--col-batch-size", default=10000, type=int)
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--eval-dir", default="./images/eval")
    p.add_argument("--precomputed-dir", default="./precomputed", type=str)
    p.add_argument("--metrics", nargs="+", default=["fid", "pr"], type=str,
                   help="any of: fid, is, pr, nll (nll needs --config-path/--ckpt-path)")
    p.add_argument("--is-splits", default=10, type=int,
                   help="number of splits for the Inception Score std")
    p.add_argument("--seed", default=1234, type=int)
    p.add_argument("--folder-name", default="", type=str)
    p.add_argument("--config-path", default="", type=str, help="experiment config (nll only)")
    p.add_argument("--ckpt-path", default="", type=str, help="checkpoint (nll only)")
    p.add_argument("--use-ema", action="store_true", help="EMA weights for nll")
    p.add_argument("--dp", action="store_true",
                   help="under torchrun: split every metric batch over the ranks")
    return p


if __name__ == "__main__":
    main()
