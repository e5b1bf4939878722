"""Data layer (counterpart of ``vdiff_tpu/data.py``): the dataset registry,
raw-format loaders, an in-memory dataset and the epoch loader.

Numpy on the host with a prefetch thread, NHWC batches in [-1, 1], the same
seeded per-epoch permutation and flips as the JAX package, so a loader built
with the same seed yields the same batches. The JAX package's native
``normalize_flip`` becomes its numpy form here (a 256-entry lookup table with
the same f32 division). CelebA is the celeba slice's (ROADMAP A7) and
per-process sharding the multi-GPU slice's (A10).
"""

from __future__ import annotations

import gzip
import os
import pickle
import queue as queue_mod
import struct
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

#: dataset registry (reference datasets.py:96-151)
DATA_INFO = {
    "mnist": {
        "num_classes": 10,
        "resolution": (32, 32),
        "channels": 1,
        "train_size": 60000,
        "test_size": 10000,
        "target_shift": 1,  # reserve 0 for the CFG null class
    },
    "cifar10": {
        "num_classes": 10,
        "resolution": (32, 32),
        "channels": 3,
        "train_size": 50000,
        "test_size": 10000,
        "random_flip": True,
        "target_shift": 1,
    },
    "celeba": {
        "num_classes": 40,
        "multitags": True,
        "resolution": (64, 64),
        "channels": 3,
        "train": 162770,
        "test": 19962,
        "validation": 19867,
        "random_flip": True,
    },
    "synthetic": {  # deterministic stand-in for tests / offline smoke runs
        "num_classes": 10,
        "resolution": (32, 32),
        "channels": 3,
        "train_size": 512,
        "test_size": 128,
        "target_shift": 1,
    },
}

DEFAULT_ROOT = os.path.expanduser("~/datasets")

_NOT_PORTED = "is not ported yet (ROADMAP.md queue A: {})"

# x / 127.5 - 1 in f32 for every byte value; 255 maps to exactly 1.0
_NORMALIZE_LUT = np.arange(256, dtype=np.float32) / np.float32(127.5) - np.float32(1.0)


def normalize_flip(images: np.ndarray, flips: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, H, W, C) uint8 → float32 in [-1, 1]; ``flips`` (N,) bool mirrors W."""
    assert images.dtype == np.uint8 and images.ndim == 4
    if flips is not None:
        images = np.where(flips[:, None, None, None], images[:, :, ::-1, :], images)
    return _NORMALIZE_LUT[images]


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def load_mnist(root: str, train: bool = True):
    """Parse MNIST idx files from ``root/MNIST/raw`` (torchvision layout)."""
    prefix = "train" if train else "t10k"
    base = None
    for cand in (os.path.join(root, "MNIST", "raw"), os.path.join(root, "mnist"), root):
        if os.path.exists(os.path.join(cand, f"{prefix}-images-idx3-ubyte")) or os.path.exists(
            os.path.join(cand, f"{prefix}-images-idx3-ubyte.gz")
        ):
            base = cand
            break
    if base is None:
        raise FileNotFoundError(f"MNIST not found under {root}")
    with _open_maybe_gz(os.path.join(base, f"{prefix}-images-idx3-ubyte")) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols, 1)
    with _open_maybe_gz(os.path.join(base, f"{prefix}-labels-idx1-ubyte")) as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
    return images, labels


def load_cifar10(root: str, train: bool = True):
    """Parse CIFAR-10 python pickle batches from ``root/cifar-10-batches-py``."""
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.exists(base):
        raise FileNotFoundError(f"CIFAR-10 not found under {root}")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    return np.ascontiguousarray(x), np.asarray(ys, np.int64)


def _resize_batch_bilinear(x: np.ndarray, size: int) -> np.ndarray:
    """Resize (N, H, W, 1) uint8 with PIL's BILINEAR filter (the JAX package's
    fallback when its native library is not built)."""
    from PIL import Image

    out = np.empty((len(x), size, size, 1), np.uint8)
    for i, img in enumerate(x):
        out[i, ..., 0] = np.asarray(Image.fromarray(img[..., 0]).resize((size, size), Image.BILINEAR))
    return out


@dataclass
class ArrayDataset:
    """In-memory uint8 NHWC images + integer labels."""

    images: np.ndarray  # (N, H, W, C) uint8
    targets: np.ndarray  # (N,) int64
    random_flip: bool = False

    def __len__(self):
        return len(self.images)


def _build_dataset(dataset: str, root: str, split: str):
    train = split in {"train", "all"}
    if dataset == "mnist":
        images, labels = load_mnist(root, train=train)
        return ArrayDataset(_resize_batch_bilinear(images, 32), labels + 1, random_flip=False)
    if dataset == "cifar10":
        images, labels = load_cifar10(root, train=train)
        return ArrayDataset(images, labels + 1, random_flip=True)
    if dataset == "celeba":
        raise NotImplementedError("the celeba dataset " + _NOT_PORTED.format("A7"))
    if dataset == "synthetic":
        n = DATA_INFO["synthetic"]["train_size" if train else "test_size"]
        rng = np.random.RandomState(0 if train else 1)
        images = rng.randint(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
        labels = rng.randint(0, 10, size=(n,)).astype(np.int64) + 1
        return ArrayDataset(images, labels, random_flip=False)
    raise NotImplementedError(dataset)


class DataLoader:
    """Epoch loader: yields (x, y), x float32 NHWC in [-1, 1], y int64 (B,).

    The per-epoch permutation is ``RandomState(seed + epoch)`` and the flips
    ``RandomState(seed * 9176 + epoch)``, as in the JAX package; ``drop_last``
    keeps every batch the same shape. A producer thread keeps ``prefetch``
    batches ready."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = 1234, drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed if seed is not None else 0
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState((self.seed + self.epoch) % (2**31)).permutation(n)
        return np.arange(n)

    def _materialize(self, idx: np.ndarray, flips: np.ndarray):
        ds = self.dataset
        x = normalize_flip(ds.images[idx], flips if ds.random_flip else None)
        return x, ds.targets[idx]

    def __iter__(self):
        indices = self._epoch_indices()
        B = self.batch_size
        nb = len(self)
        flip_rng = np.random.RandomState((self.seed * 9176 + self.epoch) % (2**31))

        def producer(q):
            # a failure must reach the consumer, or it waits on q.get() forever
            try:
                for b in range(nb):
                    idx = indices[b * B : (b + 1) * B]
                    q.put(self._materialize(idx, flip_rng.rand(len(idx)) < 0.5))
            except BaseException as exc:  # noqa: BLE001 — re-raised consumer-side
                q.put(exc)
                return
            q.put(None)

        q = queue_mod.Queue(maxsize=self.prefetch)
        threading.Thread(target=producer, args=(q,), daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def train_val_split(dataset: str, val_size: float, random_seed: Optional[int] = None):
    """Shuffled index split (reference datasets.py:154-162)."""
    train_size = DATA_INFO[dataset]["train_size"]
    if random_seed is not None:
        np.random.seed(random_seed)
    inds = np.arange(train_size)
    np.random.shuffle(inds)
    n_val = int(train_size * val_size)
    return inds[n_val:], inds[:n_val]


def get_dataloader(dataset: str, batch_size: int, split: str, val_size: float = 0.0,
                   random_seed: Optional[int] = None, root: str = DEFAULT_ROOT,
                   drop_last: bool = True, distributed: bool = False, **_ignored):
    """The JAX package's loader factory on one process; returns (loader,
    loader), the loader doubling as its own sampler (``set_epoch``)."""
    if distributed:
        raise NotImplementedError("per-process data sharding " + _NOT_PORTED.format("A10"))
    assert isinstance(val_size, float) and 0 <= val_size < 1
    if dataset != "celeba" and split in {"train", "valid"} and val_size > 0:
        base = _build_dataset(dataset, root, "train")
        train_inds, val_inds = train_val_split(dataset, val_size, random_seed)
        ind = {"train": train_inds, "valid": val_inds}[split]
        ds = ArrayDataset(base.images[ind], base.targets[ind], base.random_flip)
    elif val_size == 0 and split == "valid":
        raise ValueError("valid split requires val_size > 0")
    else:
        ds = _build_dataset(dataset, root, split)
    loader = DataLoader(ds, batch_size=batch_size, shuffle=split in {"train", "all"},
                        seed=random_seed, drop_last=drop_last)
    return loader, loader
