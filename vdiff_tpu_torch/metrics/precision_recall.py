"""Improved Precision & Recall (Kynkäänniemi et al.; counterpart of
``vdiff_tpu/metrics/precision_recall.py``).

* Features: VGG16 fc7 (``vgg.py``), or any callable (N, H, W, C) → (N, D),
  stored as float16, as the reference stores them.
* k-th nearest-neighbour radii and the precision/recall membership tests run
  as blocked pairwise squared distances on the device, ‖a‖² + ‖b‖² − 2a·bᵀ in
  float32 over (row block × column block) tiles, so the full 50k × 50k
  matrix never exists. The product is ``torch.matmul`` (the JAX package
  computes it in XLA, outside any Pallas kernel); TF32 is left to the
  caller's switch, which the eval CLI turns off.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Callable, Optional

import numpy as np
import torch

Manifold = namedtuple("Manifold", ["features", "kth"])


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, d), (n, d) → (m, n) squared euclidean distances via the
    dot-product expansion, f32, clamped at 0."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1, keepdim=True)
    return torch.clamp(a2 + b2.T - 2.0 * torch.matmul(a, b.T), min=0.0)


def _sq_dists_np(ri, cj, device="cuda") -> np.ndarray:
    """One distance tile on ``device``, returned as numpy."""
    with torch.inference_mode():
        a = torch.from_numpy(np.ascontiguousarray(ri)).to(device)
        b = torch.from_numpy(np.ascontiguousarray(cj)).to(device)
        return _sq_dists(a, b).cpu().numpy()


def compute_distance(row_features, col_features, row_batch_size=10000, col_batch_size=10000,
                     device="cuda"):
    """Blocked full distance matrix (device tiles, assembled on the host)."""
    m, n = len(row_features), len(col_features)
    out = np.empty((m, n), np.float32)
    for i in range(0, m, row_batch_size):
        ri = np.asarray(row_features[i:i + row_batch_size])
        for j in range(0, n, col_batch_size):
            cj = np.asarray(col_features[j:j + col_batch_size])
            out[i:i + row_batch_size, j:j + col_batch_size] = np.sqrt(
                _sq_dists_np(ri, cj, device))
    return out


def _kth_radii(features: np.ndarray, k: int, row_batch_size: int, col_batch_size: int,
               device="cuda"):
    """k-th nearest-neighbour distance per point (the point itself excluded
    by taking the (k+1)-th): a running top-(k+1) across column blocks."""
    n = len(features)
    kth = np.empty((n,), np.float32)
    for i in range(0, n, row_batch_size):
        ri = features[i:i + row_batch_size]
        best = np.full((len(ri), k + 1), np.inf, np.float32)
        for j in range(0, n, col_batch_size):
            d2 = _sq_dists_np(ri, features[j:j + col_batch_size], device)
            merged = np.concatenate([best, d2], axis=1)
            best = np.partition(merged, k, axis=1)[:, :k + 1]
        kth[i:i + row_batch_size] = np.sqrt(np.sort(best, axis=1)[:, k])
    return kth


class ManifoldBuilder:
    """Features and k-NN radii of a dataset or an image folder: at most
    ``max_sample_size`` items, a sorted ``RandomState(random_state)`` subsample
    where there are more."""

    def __init__(
        self,
        data=None,
        features: Optional[np.ndarray] = None,
        feature_fn: Optional[Callable] = None,
        extr_batch_size: int = 128,
        max_sample_size: int = 50000,
        nhood_size: int = 3,
        row_batch_size: int = 10000,
        col_batch_size: int = 10000,
        random_state: int = 1234,
        device="cuda",
        **_ignored,
    ):
        if features is None:
            if feature_fn is None:
                from .vgg import load_vgg_features

                feature_fn = load_vgg_features(device=device)
            n = len(data)
            idx = np.arange(n)
            if n > max_sample_size:
                idx = np.random.RandomState(random_state).choice(n, size=max_sample_size,
                                                                 replace=False)
                idx.sort()
            feats = []
            for s in range(0, len(idx), extr_batch_size):
                x = self._load(data, idx[s:s + extr_batch_size])
                feats.append(np.asarray(feature_fn(x), np.float16))
            features = np.concatenate(feats)
        self.features = features
        self.kth = _kth_radii(features.astype(np.float32), nhood_size, row_batch_size,
                              col_batch_size, device)

    @staticmethod
    def _load(data, indices):
        if hasattr(data, "load_batch"):
            return data.load_batch(indices)
        if hasattr(data, "images"):
            return data.images[indices]
        return np.stack([np.asarray(data[i]) for i in indices])

    @property
    def manifold(self) -> Manifold:
        return Manifold(self.features, self.kth)

    def save(self, path: str):
        np.savez(path, features=self.features, kth=self.kth)


def calc_pr(manifold_1: Manifold, manifold_2: Manifold, row_batch_size=10000,
            col_batch_size=10000, device="cuda", **_ignored):
    """(precision, recall): precision is the share of manifold_1's features
    inside some k-NN ball of manifold_2, recall the converse. The reference's
    order: manifold_1 generated, manifold_2 real."""

    def membership(probe: Manifold, ref: Manifold):
        hits = np.zeros((len(probe.features),), bool)
        pf = probe.features.astype(np.float32)
        rf = ref.features.astype(np.float32)
        for i in range(0, len(pf), row_batch_size):
            ri = pf[i:i + row_batch_size]
            inside = np.zeros((len(ri),), bool)
            for j in range(0, len(rf), col_batch_size):
                d2 = _sq_dists_np(ri, rf[j:j + col_batch_size], device)
                inside |= (d2 <= (ref.kth[j:j + col_batch_size] ** 2)[None, :]).any(axis=1)
            hits[i:i + row_batch_size] = inside
        return hits.mean()

    return float(membership(manifold_1, manifold_2)), float(membership(manifold_2, manifold_1))
