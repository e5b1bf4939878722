"""What the reference computes for a cell's check: the DDIM samples of chosen
rows, and the first training steps, each in blocks of rows so that it fits
beside nothing else on the card."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .diffusion import ddim_sample, train_loss
from .optim import AdamW, clip_by_global_norm, ema_update
from .unet import PlainUNet, drop_threshold, dropout_shapes


def sample_rows(cfg: dict, params: Dict[str, torch.Tensor], x_T: torch.Tensor,
                y: Optional[torch.Tensor], steps: int, w_guide: float, block: int,
                quant=None) -> torch.Tensor:
    """DDIM samples of the rows of ``x_T`` (with their labels ``y``), ``block``
    rows at a time."""
    model = PlainUNet(cfg, params, quant)
    out = []
    with torch.no_grad():
        for i in range(0, x_T.shape[0], block):
            yi = None if y is None else y[i:i + block]
            out.append(ddim_sample(model, x_T[i:i + block], yi, steps, w_guide, cfg["head"],
                                   cfg["logsnr_min"], cfg["logsnr_max"]))
    return torch.cat(out)


def dropout_generator(train_seed: int, step: int, device) -> torch.Generator:
    """The generator the training step draws its dropout bits from: seeded
    with the first 64-bit word of numpy's SeedSequence of (seed, step,
    micro-batch 0)."""
    state = np.random.SeedSequence([train_seed, step, 0]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def dropout_masks(cfg: dict, batch: int, resolution: int, generator: torch.Generator,
                  device) -> List[torch.Tensor]:
    """Each residual block's keep mask: a uniform 16-bit draw (int32 in
    [0, 2^16)) of the block's NCHW shape, kept where it is at least the
    threshold of the drop rate."""
    thresh = drop_threshold(cfg["drop_rate"])
    return [torch.randint(0, 65536, shape, generator=generator, device=device,
                          dtype=torch.int32) >= thresh
            for shape in dropout_shapes(cfg, batch, resolution)]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double()) for k in names])
    return dict(zip(names, norms.tolist()))


def train_steps(cfg: dict, train: dict, params: Dict[str, torch.Tensor], batches: List[dict],
                train_seed: int, block: int, first_step: int, quant=None) -> dict:
    """``len(batches)`` training steps from ``params`` (updated in place),
    numbered from ``first_step``: each batch {x, y, t, noise, keep}, loss and
    gradient ``block`` rows at a time and summed, then the clip, AdamW (its
    schedule at ``first_step``, its moments fresh) and the EMA. Returns the
    losses, each leaf's norm of the first clipped gradient, and each leaf's
    norm of the change of the weights and of the EMA over the steps."""
    device = next(iter(params.values())).device
    start = {k: v.clone() for k, v in params.items()}
    ema = {k: v.clone() for k, v in params.items()}
    opt = AdamW(params, train["lr"], train["beta1"], train["beta2"], train["weight_decay"],
                train["warmup"], first_step)
    model = PlainUNet(cfg, params, quant)
    names = list(params)
    losses, first_grad = [], None
    for step, b in enumerate(batches, start=first_step):
        B, res = b["x"].shape[0], b["x"].shape[1]
        masks = dropout_masks(cfg, B, res, dropout_generator(train_seed, step, device), device) \
            if cfg["drop_rate"] > 0 else None
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for p in params.values():
            p.requires_grad_(True)
        for i in range(0, B, block):
            rows = slice(i, i + block)
            keep = None if masks is None else [m[rows] for m in masks]
            y = None if b["y"] is None else b["y"][rows]
            cfg_keep = None if b["keep"] is None else b["keep"][rows]
            loss = train_loss(model, b["x"][rows], y, b["t"][rows], b["noise"][rows], cfg_keep,
                              cfg["head"], cfg["logsnr_min"], cfg["logsnr_max"], keep).sum() / B
            for k, g in zip(names, torch.autograd.grad(loss, [params[k] for k in names])):
                grads[k].add_(g)
            total += float(loss.detach())
        for p in params.values():
            p.requires_grad_(False)
        del masks
        clip_by_global_norm(list(grads.values()), train["grad_norm"])
        if first_grad is None:
            first_grad = leaf_norms(grads)
        opt.step(grads)
        ema_update(ema, params, step + 1, train["ema_decay"])
        losses.append(total)
    return {"loss": losses, "grad": first_grad,
            "change": leaf_norms({k: params[k] - start[k] for k in names}),
            "ema_change": leaf_norms({k: ema[k] - start[k] for k in names})}
