"""Inception Score: streaming split-wise KL statistics (counterpart of
``vdiff_tpu/metrics/inception_score.py``; numpy on the host, the
probabilities from ``inception.load_is_inception`` on the device).

IS = exp( E_x[ KL(p(y|x) ‖ p(y)) ] ), reported as mean ± std over ``splits``
disjoint subsets (Salimans et al. 2016 protocol; torch-fidelity computes it
over the same FID-patched InceptionV3's 1008-way head used here, see
inception.py:load_is_inception).

Streaming decomposition (per split s, over its N_s samples):
  E KL = A_s / N_s  −  Σ_y p̄_s(y)·log p̄_s(y),
  A_s  = Σ_x Σ_y p(y|x)·log p(y|x),   p̄_s = (Σ_x p(y|x)) / N_s
so each split only needs a probability-sum vector, a scalar, and a count —
O(splits·K) memory regardless of sample count. Samples are routed to splits
round-robin (generated samples carry no meaningful order).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class InceptionScoreStatistics:
    """Streaming IS accumulator. ``prob_fn`` maps an image batch (N, H, W, C)
    to (N, K) class probabilities; defaults to the FID InceptionV3 with its
    1008-class head on ``device``, loaded at the first update."""

    def __init__(
        self,
        prob_fn: Optional[Callable] = None,
        input_transform: Callable = lambda x: x,
        splits: int = 10,
        num_classes: int = 1008,
        device="cuda",
    ):
        self.input_transform = input_transform
        self.splits = splits
        self._prob_fn = prob_fn
        self._device = device
        self.sum_probs = np.zeros((splits, num_classes), np.float64)
        self.sum_plogp = np.zeros((splits,), np.float64)
        self.count = np.zeros((splits,), np.int64)
        self._seen = 0

    @property
    def prob_fn(self):
        if self._prob_fn is None:
            from .inception import load_is_inception

            self._prob_fn = load_is_inception(device=self._device)
        return self._prob_fn

    def update(self, x: np.ndarray):
        x = self.input_transform(x)
        p = np.asarray(self.prob_fn(x), np.float64)
        assert p.ndim == 2 and p.shape[1] == self.sum_probs.shape[1]
        plogp = np.sum(np.where(p > 0, p * np.log(np.maximum(p, 1e-300)), 0.0), axis=1)
        split = (self._seen + np.arange(len(p))) % self.splits
        np.add.at(self.sum_probs, split, p)
        np.add.at(self.sum_plogp, split, plogp)
        np.add.at(self.count, split, 1)
        self._seen += len(p)

    __call__ = update

    def get_statistics(self):
        """Returns (mean, std) of the per-split scores."""
        assert self.count.min() > 0, "every split needs at least one sample"
        marg = self.sum_probs / self.count[:, None]
        h_marg = np.sum(np.where(marg > 0, marg * np.log(np.maximum(marg, 1e-300)), 0.0), axis=1)
        kl = self.sum_plogp / self.count - h_marg
        scores = np.exp(kl)
        return float(scores.mean()), float(scores.std())

    def reset(self):
        self.sum_probs.fill(0)
        self.sum_plogp.fill(0)
        self.count.fill(0)
        self._seen = 0


def calc_is(probs: np.ndarray, splits: int = 10):
    """Direct (non-streaming) IS over (N, K) probabilities: per split,
    exp(mean_x KL(p(y|x) ‖ p̄(y))). Independent of the accumulator (used to
    cross-check it); splits are the same round-robin assignment."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for s in range(splits):
        p = probs[s::splits]
        marg = p.mean(axis=0, keepdims=True)
        kl = np.sum(p * (np.log(np.maximum(p, 1e-300)) - np.log(np.maximum(marg, 1e-300))),
                    axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))
