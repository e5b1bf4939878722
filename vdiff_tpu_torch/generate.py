"""Bulk sampling CLI of the port: same flags as the root ``generate.py``.

    python -m vdiff_tpu_torch.generate --config-path vdiff_tpu/configs/cifar10_cond.json \
        --ckpt-path model.pt --use-ema --use-ddim --allow-bf16 --sample-timesteps 256

Loads a reference-format torch ``.pt`` checkpoint, runs the DDIM or ancestral
sampler (with classifier-free guidance for conditional models) one batch at a
time on ``--device`` (default ``cuda``, where the steps after the first replay
one CUDA graph of the step), and writes one PNG per sample; with
``--progressive``, one horizontal strip per sample of its x̂_0 snapshots every
``--pred-freq`` steps, the most denoised first. The label stream is the JAX CLI's (numpy ``RandomState(seed)``); the initial
noise comes from a ``torch.Generator`` seeded with ``--seed`` and so differs
from the JAX CLI's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import time
import uuid
import zlib
from datetime import datetime

import numpy as np
import torch

from .data import DATA_INFO, load_celeba_index
from .factory import (DEFAULT_CONFIG_PATH, build_diffusion, build_unet, heads_note,
                      load_checkpoint_params, load_experiment_config, load_weights)

_NOT_PORTED = "is not ported yet (ROADMAP.md queue A: {})"


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 1|3) image → PNG bytes (stdlib zlib; 8-bit
    greyscale or RGB, no filtering)."""
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png wants (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + np.ascontiguousarray(img[r]).tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def make_label_stream(dataset_info, use_cfg, uncond, seed, data_root=None):
    """Per-batch labels as the JAX CLI draws them: for a multi-tag model,
    rows of the attribute table under ``data_root`` (``celeba/``, all
    splits); for a class-conditional one, uniform over 1..K; zeros of the
    label's shape with ``uncond``; None unconditional."""
    num_classes = dataset_info.get("num_classes", 0) if use_cfg else 0
    multitags = use_cfg and dataset_info.get("multitags", False)
    rng = np.random.RandomState(seed)
    if multitags:
        _, attrs, _ = load_celeba_index(data_root, split="all")

    def next_labels(n):
        if not use_cfg:
            return None
        if multitags:
            if uncond:
                return np.zeros((n, num_classes), np.float32)
            return attrs[rng.randint(len(attrs), size=(n,))].astype(np.float32)
        if uncond:
            return np.zeros((n,), np.float32)
        return (rng.randint(num_classes, size=(n,)) + 1).astype(np.float32)

    return next_labels


def write_pngs(save_dir: str, x: np.ndarray) -> None:
    """x: float (B, H, W, C) in [-1, 1] → one PNG per sample."""
    x = np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8)
    for img in x:
        with open(os.path.join(save_dir, f"{uuid.uuid4()}.png"), "wb") as f:
            f.write(encode_png(img))


def fused_note() -> str:
    """Which of the two fused-inference switches this process runs with
    (``ops/conv3x3.py::fusable``, ``ops/groupnorm.py::gn_film_silu``)."""
    on = {name: os.environ.get(name, "0") == "1" for name in ("VDIFF_FUSED_CONV", "VDIFF_FUSED_GN")}
    return ("fused inference kernels: "
            + ", ".join(f"{name}={'1 (on)' if v else 'off'}" for name, v in on.items()))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", type=str, default="~/datasets")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--total-size", type=int, default=50000)
    p.add_argument("--default-config-path", default=DEFAULT_CONFIG_PATH, type=str)
    p.add_argument("--config-path", type=str, required=True)
    p.add_argument("--ckpt-path", type=str, required=True)
    p.add_argument("--save-dir", type=str, default="./images/eval")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--use-ddim", action="store_true")
    p.add_argument("--eta", type=float, default=0.0,
                   help="DDIM noise level in [0, 1] (with --use-ddim)")
    p.add_argument("--sample-timesteps", type=int, default=1024)
    p.add_argument("--uncond", action="store_true")
    p.add_argument("--w-guide", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--dp", action="store_true", help=_NOT_PORTED.format("A10"))
    p.add_argument("--tp", action="store_true", help=_NOT_PORTED.format("A10"))
    p.add_argument("--spatial-shard", action="store_true", help=_NOT_PORTED.format("A10"))
    p.add_argument("--allow-bf16", action="store_true", help="bfloat16 UNet activations")
    p.add_argument("--progressive", action="store_true",
                   help="write each sample's x̂_0 snapshots every --pred-freq steps as one strip")
    p.add_argument("--pred-freq", type=int, default=50)
    return p


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns a summary (save_dir, images written,
    whether every sample was finite, seconds spent sampling, and the
    sampler's ``stats`` summed over the batches: steps run eagerly, graph
    captures and replays, and each kernel's launches on the device)."""
    args = build_parser().parse_args(argv)
    for flag in ("dp", "tp", "spatial_shard"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} " + _NOT_PORTED.format("A10"))
    if args.progressive and args.pred_freq < 1:
        raise SystemExit(f"--pred-freq must be at least 1, got {args.pred_freq}")
    if not 0.0 <= args.eta <= 1.0:
        raise SystemExit(f"--eta must lie in [0, 1], got {args.eta}")
    if args.eta and not args.use_ddim:
        raise SystemExit("--eta is a DDIM noise level; pass --use-ddim with it")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    # f32 means f32: no TF32 in matmuls or convs (bf16 runs are unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    state_dict, head_keys = load_checkpoint_params(args.ckpt_path, use_ema=args.use_ema)
    use_cfg = "class_embed" in head_keys
    config, exp_name = load_experiment_config(args.config_path, args.default_config_path)
    info = DATA_INFO[config["data"]["name"]]

    w_guide = args.w_guide if (use_cfg and not args.uncond) else 0.0
    diffusion, _ = build_diffusion(config["diffusion"], w_guide=w_guide,
                                   sample_timesteps=args.sample_timesteps, continuous_gate=False)
    model = build_unet(
        config["model"], in_channels=info["channels"],
        model_out_type=config["diffusion"]["model_out_type"],
        num_classes=info.get("num_classes", 0) if use_cfg else 0,
        multitags=info.get("multitags", False) if use_cfg else False,
        dtype=torch.bfloat16 if args.allow_bf16 else torch.float32,
        model_var_type=config["diffusion"]["model_var_type"],
    )
    if heads_note(config["model"]):
        print(heads_note(config["model"]))
    print(fused_note())
    load_weights(model, state_dict)
    model = model.to(device).eval()

    timestamp = datetime.now().strftime("%Y-%m-%dT%H%M%S%f")
    save_dir = os.path.join(args.save_dir, exp_name, timestamp)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.txt"), "w") as f:
        json.dump(vars(args), f)

    res = info["resolution"][0]
    shape = (args.batch_size, res, res, info["channels"])
    next_labels = make_label_stream(info, use_cfg, args.uncond, args.seed,
                                    os.path.expandvars(os.path.expanduser(args.data_root)))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    num_batches = math.ceil(args.total_size / args.batch_size)
    finite, seconds, written, stats = True, 0.0, 0, {}
    with torch.inference_mode():
        for i in range(num_batches):
            n = min(args.batch_size, args.total_size - i * args.batch_size)
            labels = next_labels(args.batch_size)
            y = None if labels is None else torch.as_tensor(labels, device=device)
            x_T = torch.randn(shape, generator=gen, device=device)
            t0 = time.perf_counter()
            kw = dict(label=y, use_ddim=args.use_ddim, eta=args.eta, generator=gen, stats=stats)
            if args.progressive:
                _, x = diffusion.p_sample_progressive(model, x_T, pred_freq=args.pred_freq, **kw)
                x = torch.cat(list(x), dim=2)  # (B, H, L·W, C): one strip per sample
            else:
                x = diffusion.p_sample(model, x_T, **kw)
            x = x[:n].float().cpu().numpy()  # waits for the device
            dt = time.perf_counter() - t0
            seconds += dt
            finite &= bool(np.isfinite(x).all())
            write_pngs(save_dir, x)
            written += n
            if i == 0:  # it pays for the kernels' build and cuDNN's choices
                first_n, first_s = n, dt
                print(f"batch 1/{num_batches}: {n} images in {dt:.3f} s, the warm-up included",
                      flush=True)
            else:
                print(f"batch {i + 1}/{num_batches}: {n} images, "
                      f"{(written - first_n) / (seconds - first_s):.3f} samples/s over the "
                      "batches after the first", flush=True)
    return {"save_dir": save_dir, "images": written, "finite": finite, "seconds": seconds,
            "stats": stats}


if __name__ == "__main__":
    main()
