"""Weights and inputs made from the seed, on the device, in a few large calls.

Every weight is a slice of one standard-normal draw: matrices and kernels
scaled by 1/√fan_in, GroupNorm scales 1 + 0.1·z, every bias 0.1·z. No weight
is zero (the published initialisation zeroes the output projections, which
would leave whole layers out of the comparison). The same seed gives the same
dict on any run; the program and the reference each get it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .spec import sub_seed


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) >= 2:
            w.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith(".weight"):
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(0.1)
        out[name] = w
    return out


def labels(cfg: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """Classes uniform over 1..K, or K multi-hot tags Bernoulli(tag_rate)."""
    K = cfg["num_classes"]
    if cfg["multitags"]:
        return (torch.rand((n, K), generator=gen, device=device) < cfg["tag_rate"]).float()
    return torch.randint(1, K + 1, (n,), generator=gen, device=device).float()


def sample_inputs(cfg: dict, batch: int, seed: int, call: int, device):
    """x_T and the labels of one sampling call."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "sample", call))
    r, c = cfg["resolution"], cfg["in_channels"]
    x_T = torch.randn((batch, r, r, c), generator=gen, device=device)
    return x_T, labels(cfg, batch, gen, device)


def train_inputs(cfg: dict, batch: int, seed: int, step: int, p_uncond: float, device) -> dict:
    """One training step's rows: images U(-1, 1), labels, t ~ U(0, 1), the
    noise and the CFG keep mask (U(0, 1) > p_uncond)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "train", step))
    r, c = cfg["resolution"], cfg["in_channels"]
    x = torch.rand((batch, r, r, c), generator=gen, device=device) * 2.0 - 1.0
    y = labels(cfg, batch, gen, device)
    t = torch.rand((batch,), generator=gen, device=device)
    noise = torch.randn((batch, r, r, c), generator=gen, device=device)
    keep = torch.rand((batch,), generator=gen, device=device) > p_uncond
    return {"x": x, "y": y, "t": t, "noise": noise, "keep": keep}
