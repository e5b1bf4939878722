"""Misc utilities: seeding, sample-grid images, 2-D toy-data helpers (the
histogram and its discrete KL too), running statistics (counterpart of ``vdiff_tpu/utils/misc.py``). The grid is
assembled in numpy and written with the port's stdlib PNG encoder; the
scatterplot imports matplotlib when it is called."""

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


def split_squeeze(data):
    """(N, 2) → (x, y) vectors."""
    x, y = np.split(np.asarray(data), 2, axis=1)
    return x.squeeze(1), y.squeeze(1)


def infer_range(dataset, precision: int = 2):
    """x/y axis limits over batches of 2-D points, rounded outwards to
    1/precision."""
    p = precision
    xlim = np.array([-np.inf, np.inf])
    ylim = np.array([-np.inf, np.inf])
    clip = lambda lo, hi, lim: np.clip([math.floor(p * lo), math.ceil(p * hi)], *lim)
    for bch in dataset:
        bch = np.asarray(bch)
        xlim = clip(bch[:, 0].min(), bch[:, 0].max(), xlim)
        ylim = clip(bch[:, 1].min(), bch[:, 1].max(), ylim)
    return xlim / p, ylim / p


def save_scatterplot(fpath, x, y=None, xlim=None, ylim=None):
    """Toy-data scatterplot: (N, 2) points, or y against x (against its
    index when y is None)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(x)
    if x.ndim == 2:
        x, y = split_squeeze(x)
    elif y is None:
        x, y = np.arange(len(x)), x
    plt.figure(figsize=(6, 6))
    plt.scatter(x, y, s=0.5, alpha=0.7)
    if xlim is not None:
        plt.xlim(*xlim)
    if ylim is not None:
        plt.ylim(*ylim)
    plt.tight_layout()
    plt.savefig(fpath)
    plt.close()


def discrete_klv2d(hist1, hist2, eps: float = 1e-9):
    """Discretized empirical KL between two 2-D histograms,
    Σ hist2·(log(hist2 + eps) − log(hist1 + eps)) (toy-data evaluation)."""
    hist1, hist2 = np.asarray(hist1), np.asarray(hist2)
    return np.sum(hist2 * (np.log(hist2 + eps) - np.log(hist1 + eps)))


def hist2d(data, bins, value_range=None):
    """2-D histogram matrix of an (N, 2) point set. ``bins="auto"`` takes
    ⌊√(N // 10)⌋; ``value_range`` is a number r (both axes (-r, r)), one
    (lo, hi) pair for both axes, or a pair of pairs."""
    data = np.asarray(data)
    if bins == "auto":
        bins = math.floor(math.sqrt(len(data) // 10))
    if value_range is not None:
        if isinstance(value_range, (int, float)):
            value_range = ((-value_range, value_range),) * 2
        elif hasattr(value_range, "__iter__"):
            if not hasattr(next(iter(value_range)), "__iter__"):
                value_range = (tuple(value_range),) * 2
    x, y = data[:, 0], data[:, 1]
    return np.histogram2d(x, y, bins=bins, range=value_range)[0]


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
