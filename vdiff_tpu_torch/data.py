"""Data layer (counterpart of ``vdiff_tpu/data.py``): the dataset registry,
raw-format loaders, an in-memory dataset, the eval CLI's image folder and the
epoch loader.

Numpy on the host with a prefetch thread, NHWC batches in [-1, 1], the same
seeded per-epoch permutation and flips as the JAX package, so a loader built
with the same seed yields the same batches. The JAX package's native
``normalize_flip`` becomes its numpy form here (a 256-entry lookup table with
the same f32 division), and its native ``crop_resize_bilinear`` a numpy
copy of the same fixed-point PIL resampler, equal to it bit for bit.
Under torchrun (``distributed=True``) each rank loads a contiguous shard of
the one seeded permutation, at the global batch divided by the world size,
as each JAX process does.
"""

from __future__ import annotations

import csv
import gzip
import math
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


def _resize_batch_bilinear(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Resize (N, H, W, C) uint8 to (N, oh, ow, C) with PIL's fixed-point
    BILINEAR filter (:func:`crop_resize_bilinear` on the whole image), bit
    for bit as the JAX package's ``native.resize_bilinear``."""
    return crop_resize_bilinear(x, 0, 0, x.shape[1], x.shape[2], oh, ow)


def load_celeba_index(root: str, split: str = "all"):
    """Parse CelebA's text tables under ``root/celeba`` (reference
    datasets.py:57-72): returns (filenames, attrs in {0,1} float32 (N, K),
    attr_names)."""
    base = os.path.join(root, "celeba")
    with open(os.path.join(base, "list_eval_partition.txt")) as f:
        rows = [r for r in csv.reader(f, delimiter=" ", skipinitialspace=True) if r]
    with open(os.path.join(base, "list_attr_celeba.txt")) as f:
        attr_rows = [r for r in csv.reader(f, delimiter=" ", skipinitialspace=True) if r]
    attr_names, attr_rows = attr_rows[1], attr_rows[2:]
    filenames = [r[0] for r in rows]
    partition = np.asarray([int(r[1]) for r in rows])
    attr = np.asarray([[int(v) for v in r[1:]] for r in attr_rows], np.float32)
    attr = 0.5 * (attr + 1.0)  # {-1,1} -> {0,1}
    part = {"train": 0, "valid": 1, "test": 2, "all": None}[split.lower()]
    if part is not None:
        mask = partition == part
        filenames = [f for f, m in zip(filenames, mask) if m]
        attr = attr[mask]
    return filenames, attr, attr_names


# PIL's fixed-point resampling (Resample.c), as the JAX package's native
# dataops.cpp reimplements it: triangle filter whose support grows with the
# downscale factor, weights in 22-bit fixed point, a horizontal pass into a
# uint8 intermediate, then a vertical pass.
_PRECISION_BITS = 32 - 8 - 2


def _resample_coeffs(in_size: int, out_size: int):
    """(first input index (out,), fixed-point weights (out, ksize) int64) of
    every output pixel, as dataops.cpp's ``precompute_coeffs`` on the whole
    axis: double arithmetic in the same order, truncating casts."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = 0.0 if ww == 0.0 else v / ww
            weights[xx, x] = int((-0.5 if v < 0 else 0.5) + v * (1 << _PRECISION_BITS))
        starts[xx] = xmin
    return starts, weights


def _resample_axis(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable pass along ``axis`` of a uint8 array, rounded and clipped
    to uint8 as PIL does."""
    starts, weights = _resample_coeffs(x.shape[axis], out_size)
    idx = np.minimum(starts[:, None] + np.arange(weights.shape[1]), x.shape[axis] - 1)
    taps = np.take(x.astype(np.int64), idx, axis=axis)  # axis → (out, ksize)
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = weights.shape
    acc = (taps * weights.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return (np.clip(acc, 0, (1 << _PRECISION_BITS << 8) - 1) >> _PRECISION_BITS).astype(np.uint8)


def crop_resize_bilinear(images: np.ndarray, top: int, left: int, ch: int, cw: int,
                         oh: int, ow: int) -> np.ndarray:
    """(N, H, W, C) uint8 → crop (top, left, ch, cw) → PIL-BILINEAR resize to
    (N, oh, ow, C) uint8, bit-equal to ``im.crop(box).resize(size, BILINEAR)``
    and to the JAX package's ``native.crop_resize_bilinear``."""
    assert images.dtype == np.uint8 and images.ndim == 4
    crop = images[:, top:top + ch, left:left + cw]
    return _resample_axis(_resample_axis(crop, 2, ow), 1, oh)


@dataclass
class ArrayDataset:
    """In-memory uint8 NHWC images + integer labels."""

    images: np.ndarray  # (N, H, W, C) uint8
    targets: np.ndarray  # (N,) int64
    random_flip: bool = False

    def __len__(self):
        return len(self.images)


class CelebADataset:
    """Lazily decoded CelebA (``root/celeba/img_align_celeba``): the reference
    transform crop(top=40, left=15, 148×148) → 64×64 PIL-BILINEAR, then the
    loader's flip and normalisation. JPEG decoding (PIL, imported where it is
    used) fans out over ``num_workers`` threads."""

    random_flip = True

    def __init__(self, root: str, split: str = "all", num_workers: int = 0):
        self.root = root
        self.filenames, self.attr, self.attr_names = load_celeba_index(root, split)
        self.num_workers = num_workers
        self._pool = None

    @property
    def targets(self):
        return self.attr

    def __len__(self):
        return len(self.filenames)

    def _decode_one(self, filename: str) -> np.ndarray:
        from PIL import Image

        with Image.open(os.path.join(self.root, "celeba", "img_align_celeba", filename)) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    def load_batch(self, indices: np.ndarray) -> np.ndarray:
        """(B, 64, 64, 3) uint8 of the images at ``indices``."""
        names = [self.filenames[i] for i in indices]
        if self.num_workers > 1 and len(names) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            raws = list(self._pool.map(self._decode_one, names))
        else:
            raws = [self._decode_one(f) for f in names]
        return crop_resize_bilinear(np.stack(raws), 40, 15, 148, 148, 64, 64)


class ImageFolder:
    """A flat directory of images (the eval CLI's input), decoded batch by
    batch with PIL (imported where it is used) into uint8 NHWC RGB."""

    EXTS = {"jpg", "jpeg", "png", "bmp", "webp", "tiff"}

    def __init__(self, img_dir: str):
        self.img_dir = img_dir
        self.img_list = [f for f in os.listdir(img_dir) if f.split(".")[-1].lower() in self.EXTS]

    def __len__(self):
        return len(self.img_list)

    def load_batch(self, indices: np.ndarray) -> np.ndarray:
        from PIL import Image

        out = []
        for i in indices:
            with Image.open(os.path.join(self.img_dir, self.img_list[i])) as im:
                out.append(np.asarray(im.convert("RGB"), np.uint8))
        return np.stack(out)


def _build_dataset(dataset: str, root: str, split: str, num_workers: int = 0):
    train = split in {"train", "all"}
    if dataset == "mnist":
        images, labels = load_mnist(root, train=train)
        return ArrayDataset(_resize_batch_bilinear(images, 32, 32), labels + 1, random_flip=False)
    if dataset == "cifar10":
        images, labels = load_cifar10(root, train=train)
        return ArrayDataset(images, labels + 1, random_flip=True)
    if dataset == "celeba":
        return CelebADataset(root, split=split, num_workers=num_workers)
    if dataset == "synthetic":
        n = DATA_INFO["synthetic"]["train_size" if train else "test_size"]
        rng = np.random.RandomState(0 if train else 1)
        images = rng.randint(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
        labels = rng.randint(0, 10, size=(n,)).astype(np.int64) + 1
        return ArrayDataset(images, labels, random_flip=False)
    raise NotImplementedError(dataset)


class DataLoader:
    """Epoch loader: yields (x, y), x float32 NHWC in [-1, 1], y int64 (B,)
    or float32 (B, K) tags.

    The per-epoch permutation is ``RandomState(seed + epoch)`` and the flips
    ``RandomState(seed * 9176 + epoch + 7 * process_index)``, as in the JAX
    package; ``drop_last`` keeps every batch the same shape. Process
    ``process_index`` of ``process_count`` takes the contiguous
    ``process_index``-th shard of the permutation (``len(dataset) //
    process_count`` items), and its length counts its own batches. A
    producer thread keeps ``prefetch`` batches ready."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = 1234, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed if seed is not None else 0
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState((self.seed + self.epoch) % (2**31)).permutation(n)
        else:
            order = np.arange(n)
        shard = n // self.process_count
        return order[self.process_index * shard:(self.process_index + 1) * shard]

    def _materialize(self, idx: np.ndarray, flips: np.ndarray):
        ds = self.dataset
        images = ds.load_batch(idx) if isinstance(ds, CelebADataset) else ds.images[idx]
        return normalize_flip(images, flips if ds.random_flip else None), ds.targets[idx]

    def __iter__(self):
        indices = self._epoch_indices()
        B = self.batch_size
        nb = len(self)
        flip_rng = np.random.RandomState(
            (self.seed * 9176 + self.epoch + 7 * self.process_index) % (2**31))

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
                   drop_last: bool = True, distributed: bool = False, num_workers: int = 0,
                   **_ignored):
    """The JAX package's loader factory; returns (loader, loader), the
    loader doubling as its own sampler (``set_epoch``). ``batch_size`` is the
    global batch: with ``distributed`` (a process group joined, as torchrun's
    ranks have) it is divided by the world size and each rank loads its
    shard. Every rank then builds the dataset, meets the others at a barrier
    and only then raises if its build failed, so a dataset missing on some or
    all ranks stops each of them with ``FileNotFoundError`` and leaves none
    waiting at a later barrier."""
    from .parallel.mesh import rank, sync_global_devices, world_size

    process_index = rank() if distributed else 0
    process_count = world_size() if distributed else 1
    if distributed:
        batch_size = batch_size // process_count
    assert isinstance(val_size, float) and 0 <= val_size < 1

    def build():
        if dataset != "celeba" and split in {"train", "valid"} and val_size > 0:
            base = _build_dataset(dataset, root, "train")
            train_inds, val_inds = train_val_split(dataset, val_size, random_seed)
            ind = {"train": train_inds, "valid": val_inds}[split]
            return ArrayDataset(base.images[ind], base.targets[ind], base.random_flip)
        if val_size == 0 and split == "valid":
            raise ValueError("valid split requires val_size > 0")
        return _build_dataset(dataset, root, split, num_workers=num_workers)

    if distributed:
        try:
            ds = build()
        except FileNotFoundError:
            ds = None
        sync_global_devices("dataset_download")
        if ds is None:
            ds = build()
    else:
        ds = build()
    loader = DataLoader(ds, batch_size=batch_size, shuffle=split in {"train", "all"},
                        seed=random_seed, drop_last=drop_last, process_index=process_index,
                        process_count=process_count)
    return loader, loader
