"""Misc utilities: seeding, sample-grid images, running statistics
(counterpart of ``vdiff_tpu/utils/misc.py``). The grid is assembled in numpy
and written with the port's stdlib PNG encoder."""

from __future__ import annotations

import math
import random

import numpy as np
import torch


def seed_all(seed: int) -> None:
    """Seed python, numpy and torch's global generators. The training draws
    (t, noise, CFG mask, dropout) use their own generators seeded from
    (seed, step)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_grid(x: np.ndarray, nrow: int = 8, padding: int = 2, value_range=(-1.0, 1.0)):
    """Assemble an (N, H, W, C) batch into one grid image in [0, 1]."""
    n, h, w, c = x.shape
    lo, hi = value_range
    x = np.clip((x.astype(np.float32) - lo) / (hi - lo), 0.0, 1.0)
    ncol = nrow
    nrows = math.ceil(n / ncol)
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c), np.float32
    )
    for idx in range(n):
        r, cidx = divmod(idx, ncol)
        top = r * (h + padding) + padding
        left = cidx * (w + padding) + padding
        grid[top : top + h, left : left + w] = x[idx]
    return grid


def save_image(x, path: str, nrow: int = 8, value_range=(-1.0, 1.0)) -> None:
    """Save a sample batch (N, H, W, C) in value_range as a PNG grid."""
    from ..generate import encode_png

    grid = make_grid(np.asarray(x), nrow=nrow, value_range=value_range)
    with open(path, "wb") as f:
        f.write(encode_png((grid * 255.0 + 0.5).astype(np.uint8)))


class RunningStatistics:
    """Streaming per-epoch averages."""

    def __init__(self, **kwargs):
        self.count = 0
        self.stats = {k: (v or 0) for k, v in kwargs.items()}

    def reset(self):
        self.count = 0
        for k in self.stats:
            self.stats[k] = 0

    def update(self, n, **kwargs):
        self.count += n
        for k, v in kwargs.items():
            self.stats[k] = self.stats.get(k, 0) + v

    def extract(self):
        if self.count == 0:
            return {k: 0.0 for k in self.stats}
        return {k: v / self.count for k, v in self.stats.items()}
