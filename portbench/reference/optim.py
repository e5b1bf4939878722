"""The reference's optimizer: global-norm clipping without an eps, AdamW with
a linear warm-up, and the EMA of the weights, written out per tensor in
plain PyTorch.

AdamW follows PyTorch's published algorithm step for step (decay of the old
weight by lr·wd, the moments, bias corrections at the step count, the
denominator √v̂ + eps), so that both sides round a first update of ±lr alike.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / ‖g‖ where ‖g‖ ≥ max_norm; returns ‖g‖."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if float(norm) >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


class AdamW:
    """AdamW over a dict of tensors, the learning rate lr·min((n+1)/warmup, 1)
    at the n-th update, counted from ``start``; the bias corrections count
    this object's own updates."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, beta1: float, beta2: float,
                 weight_decay: float, warmup: int, start: int, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2 = params, lr, beta1, beta2
        self.wd, self.warmup, self.eps = weight_decay, warmup, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count, self.start = 0, start

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        n = self.start + self.count
        lr = self.lr * min((n + 1.0) / self.warmup, 1.0) if self.warmup else self.lr
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2_sqrt = (1.0 - self.b2 ** self.count) ** 0.5
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].lerp_(g, 1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], num_updates: int,
               decay: float) -> None:
    """shadow += (1 - d)·(p - shadow), d = min(decay, (1 + n)/(10 + n)), n
    the number of updates made."""
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    for k, e in ema.items():
        e.add_(params[k] - e, alpha=1.0 - d)
