"""FID: streaming activation statistics and the Fréchet distance (counterpart
of ``vdiff_tpu/metrics/fid.py``).

The running mean/covariance is kept in numpy float64 on the host; the
features come from the FID InceptionV3 (``inception.py``) run batched on the
device; the matrix square root runs through scipy on the host. Reference
statistics are local npz files (``mu``/``sigma``, TTUR format):
``get_precomputed`` searches ``download_dir`` and raises with the expected
file name if it is absent.

    python -m vdiff_tpu_torch.metrics.fid DIR_OR_NPZ DIR_OR_NPZ [--device cpu]
    python -m vdiff_tpu_torch.metrics.fid DIR OUT.npz --save-stats
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
from scipy import linalg

# TTUR stats filenames per dataset (fid_score.py:140-150)
PRECOMPUTED_FILES = {
    "cifar10": "fid_stats_cifar10_train.npz",
    "celeba": "fid_stats_celeba_148x148.npz",
    "cropped_celeba": "fid_stats_celeba_148x148.npz",
    "lsun_bedroom": "fid_stats_lsun_train.npz",
    "svhn": "fid_stats_svhn_train.npz",
    "imagenet_train": "fid_stats_imagenet_train.npz",
    "imagenet_valid": "fid_stats_imagenet_valid.npz",
}


def get_precomputed(dataset: str, download_dir: str = "precomputed"):
    """Load precomputed reference (mu, sigma) from a local npz."""
    if dataset == "celeba":
        dataset = "cropped_celeba"
    fname = PRECOMPUTED_FILES.get(dataset, f"fid_stats_{dataset}.npz")
    for cand in (os.path.join(download_dir, fname), fname):
        if os.path.exists(cand):
            data = np.load(cand)
            return data["mu"], data["sigma"]
    raise FileNotFoundError(
        f"Precomputed FID statistics '{fname}' not found in '{download_dir}'. "
        "This environment has no network egress — place the TTUR npz there "
        "manually (keys: mu, sigma)."
    )


class InceptionStatistics:
    """Streaming mean/cov over feature activations (fid_score.py:78-137).

    ``feature_fn`` maps a uint8/float image batch (N, H, W, C) to (N, D)
    activations; defaults to the FID InceptionV3's pool3 features on
    ``device`` (each rank its slice of a batch, with a data ``mesh``), loaded
    at the first update. ``input_transform`` is applied to each batch first.
    """

    def __init__(
        self,
        feature_fn: Optional[Callable] = None,
        input_transform: Callable = lambda x: x,
        activation_dim: int = 2048,
        device="cuda",
        mesh=None,
    ):
        self.input_transform = input_transform
        self.activation_dim = activation_dim
        self._feature_fn = feature_fn
        self._device = device
        self._mesh = mesh
        self.reset()

    @property
    def feature_fn(self):
        if self._feature_fn is None:
            from .inception import load_fid_inception

            self._feature_fn = load_fid_inception(device=self._device, mesh=self._mesh)
        return self._feature_fn

    def update(self, x: np.ndarray):
        """x: (N, H, W, C) images; accumulates first/second raw moments.

        Streaming via f64 raw-moment sums (Σa and Σaᵀa): batch-order
        independent and exact up to f64 rounding — activations are O(1), so
        no catastrophic cancellation in cov = E[aᵀa] − μᵀμ."""
        x = self.input_transform(x)
        act = np.asarray(self.feature_fn(x), np.float64)
        assert act.ndim == 2 and act.shape[1] == self.activation_dim
        self._sum += act.sum(axis=0)
        self._sumsq += act.T @ act
        self.count += act.shape[0]

    __call__ = update

    def get_statistics(self):
        """Returns (mean, unbiased covariance) over everything seen so far."""
        n = self.count
        if n < 2:
            raise ValueError(f"need at least 2 samples for a covariance, got {n}")
        mean = self._sum / n
        cov = (self._sumsq - n * np.outer(mean, mean)) / (n - 1)
        return mean, cov

    def reset(self):
        D = self.activation_dim
        self._sum = np.zeros((D,), np.float64)
        self._sumsq = np.zeros((D, D), np.float64)
        self.count = 0


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """‖μ₁−μ₂‖² + Tr(Σ₁+Σ₂−2√(Σ₁Σ₂)), with an ε on the diagonals where the
    product's square root is not finite."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def calc_fd(mean1, var1, mean2, var2, eps=1e-6):
    return calculate_frechet_distance(mean1, var1, mean2, var2, eps)


def compute_statistics_of_path(path, feature_fn=None, batch_size=50, device="cuda",
                               dims=2048, mesh=None):
    """(mu, sigma) for a path: an ``.npz`` stats file (keys mu/sigma) loads
    directly; an image directory streams through the Inception features on
    ``device``. ``dims`` is the feature width (a custom ``feature_fn``'s
    too)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    from ..data import ImageFolder

    folder = ImageFolder(path)
    if len(folder) == 0:
        raise FileNotFoundError(f"no images found under '{path}'")
    istats = InceptionStatistics(feature_fn=feature_fn, device=device, activation_dim=dims,
                                 mesh=mesh)
    for s in range(0, len(folder), batch_size):
        istats(folder.load_batch(np.arange(s, min(s + batch_size, len(folder)))))
    return istats.get_statistics()


def calculate_fid_given_paths(paths, batch_size=50, feature_fn=None, device="cuda",
                              dims=2048, mesh=None):
    """FID between two paths, each an image directory or a stats npz. With a
    data ``mesh`` every rank calls it; the distance is computed on rank 0 and
    broadcast."""
    from ..parallel.mesh import leader_value

    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    m1, s1 = compute_statistics_of_path(paths[0], feature_fn, batch_size, device, dims, mesh)
    m2, s2 = compute_statistics_of_path(paths[1], feature_fn, batch_size, device, dims, mesh)
    return leader_value(lambda: calculate_frechet_distance(m1, s1, m2, s2), mesh)


def main(argv=None):
    """``python -m vdiff_tpu_torch.metrics.fid path1 path2``: the FID between
    two image directories or stats npz files; with ``--save-stats``, path1's
    statistics written to the path2 npz (a user's own reference statistics).
    Runs on ``--device`` (default cuda; no fallback to the CPU, ``--device
    cpu`` asks for it); with ``--dp`` under torchrun each rank runs its slice
    of every Inception batch, rank 0 computes the distance and writes."""
    from argparse import ArgumentParser

    import torch

    from ..parallel.mesh import is_leader
    from .device_apply import resolve_eval_mesh

    parser = ArgumentParser(description=main.__doc__)
    parser.add_argument("path", type=str, nargs=2,
                        help="image directories or .npz statistic files")
    parser.add_argument("--batch-size", type=int, default=50)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dp", action="store_true",
                        help="split each Inception batch over torchrun's ranks")
    parser.add_argument("--save-stats", action="store_true",
                        help="compute stats of path[0] and write them to the "
                             "path[1] npz instead of computing a FID")
    args = parser.parse_args(argv)
    mesh, device = resolve_eval_mesh(args.dp, args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        if args.save_stats:
            mu, sigma = compute_statistics_of_path(args.path[0], batch_size=args.batch_size,
                                                   device=device, mesh=mesh)
            if is_leader():
                np.savez(args.path[1], mu=mu, sigma=sigma)
                print(f"saved statistics for '{args.path[0]}' to '{args.path[1]}'")
            return None
        fid = calculate_fid_given_paths(args.path, args.batch_size, device=device, mesh=mesh)
        if is_leader():
            print("FID: ", fid)
        return fid
    except FileNotFoundError as e:  # weights and images are local files
        raise SystemExit(f"FID skipped: {e}")


if __name__ == "__main__":
    main()
