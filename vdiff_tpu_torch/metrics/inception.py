"""FID-patched InceptionV3 as a torch ``nn.Module`` (counterpart of
``vdiff_tpu/metrics/inception.py``).

Its parameter names are pytorch-fid's (torchvision's inception_v3 without the
aux head, with the 1008-way ``fc``), so the release file
``pt_inception-2015-12-05-6726825d.pth`` loads with
``load_state_dict(strict=True)``. The FID network's quirks are kept, as the
JAX package keeps them: BasicConv2d = conv (no bias) + BatchNorm(eps=1e-3) +
ReLU; the pool branches of InceptionA, C and E_1 average with
``count_include_pad=False``; Mixed_7c's pool branch takes a max; the stem's
and reductions' 3×3/2 max pools are VALID; inputs are resized to 299×299
bilinearly (``align_corners=False``, no antialias: ``jax.image.resize(...,
"bilinear", antialias=False)``) and are in [-1, 1] (``normalize_input`` maps
[0, 1] there); the features are the 2048-d pool3 activations, and the
1008-way logits of ``fc`` feed the Inception Score.

Weights are local files (no download): :func:`load_fid_inception` and
:func:`load_is_inception` search the JAX package's directories.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FID_WEIGHTS_FILENAME = "pt_inception-2015-12-05-6726825d.pth"
_SEARCH_DIRS = (
    "precomputed",
    os.path.expanduser("~/.cache/torch/hub/checkpoints"),
    os.path.expanduser("~/datasets"),
    ".",
)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    """3×3, stride 1, pad 1, the padding not counted (the TF/FID convention)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)  # VALID


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool="avg"``: FIDInceptionE_1 (Mixed_7b); ``"max"``: FIDInceptionE_2
    (Mixed_7c), whose pool branch takes a 3×3 max with stride 1."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW ``x`` resized to size×size: bilinear, half-pixel centres, no
    antialias (``jax.image.resize(..., "bilinear", antialias=False)``)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=False)


class InceptionV3(nn.Module):
    """FID InceptionV3 feature extractor on NHWC input.

    ``output_blocks`` select the tap points by index {0: 64-d, 1: 192-d, 2:
    768-d, 3: 2048-d}; each tap is returned NHWC, the last (N, 1, 1, 2048).
    Input: float in [-1, 1] (``normalize_input=False``) or [0, 1]; resized to
    299×299 when ``resize_input``. ``include_head`` appends the 1008-way
    logits of ``fc`` (the Inception Score's head); the module holds ``fc``
    either way, so the release file loads strictly."""

    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True,
                 normalize_input: bool = False, include_head: bool = False):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.include_head = include_head
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)
        self.eval()

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_bilinear(x, 299)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        last = max(self.output_blocks)
        outputs = {}
        x = _max_pool(self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x))))
        outputs[0] = x
        if last > 0:
            x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
            outputs[1] = x
        if last > 1:
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                          self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
                x = block(x)
            outputs[2] = x
        if last > 2:
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
            x = x.mean(dim=(2, 3), keepdim=True)  # adaptive average pool to 1×1
            outputs[3] = x
        outs = [outputs[i].permute(0, 2, 3, 1) for i in self.output_blocks]
        if self.include_head:
            outs.append(self.fc(x.flatten(1)))
        return outs


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def inception_state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's InceptionV3 variables ({params, batch_stats}, numpy
    arrays, as ``vdiff_tpu.metrics.inception.convert_fid_weights`` makes them)
    → this module's state_dict (torch tensors): the converter's inverse.
    ``fc`` is there when the variables carry the head."""
    sd = {}

    def walk(tree, path):
        for name, node in tree.items():
            if isinstance(node, dict):
                yield from walk(node, path + [name])
            else:
                yield path + [name], np.asarray(node)

    for path, arr in walk(variables["params"], []):
        *mod, leaf = path
        key = ".".join(mod)
        if mod == ["fc"]:
            sd[f"fc.{'weight' if leaf == 'kernel' else 'bias'}"] = arr.T if leaf == "kernel" else arr
        elif leaf == "kernel":
            sd[f"{key}.weight"] = arr.transpose(3, 2, 0, 1)  # (kh, kw, in, out) → (out, in, kh, kw)
        else:
            sd[f"{key}.{'weight' if leaf == 'scale' else 'bias'}"] = arr
    for path, arr in walk(variables["batch_stats"], []):
        *mod, leaf = path
        key = ".".join(mod)
        sd[f"{key}.running_{leaf}"] = arr
        sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def find_fid_weights() -> Optional[str]:
    for d in _SEARCH_DIRS:
        cand = os.path.join(d, FID_WEIGHTS_FILENAME)
        if os.path.exists(cand):
            return cand
    return None


def _load_inception(weights_path: Optional[str], include_head: bool, device) -> InceptionV3:
    weights_path = weights_path or find_fid_weights()
    if weights_path is None:
        raise FileNotFoundError(
            f"FID InceptionV3 weights '{FID_WEIGHTS_FILENAME}' not found in "
            f"{_SEARCH_DIRS}. No network egress here — place the pytorch-fid "
            "release file in one of those directories."
        )
    model = InceptionV3(output_blocks=(3,), resize_input=True, normalize_input=False,
                        include_head=include_head)
    model.load_state_dict(torch.load(weights_path, map_location="cpu", weights_only=True),
                          strict=True)
    return model.to(device).eval()


def _images(x) -> np.ndarray:
    """uint8 images → float32 in [-1, 1]; grayscale tiled to 3 channels."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 127.5 - 1.0
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x.astype(np.float32, copy=False)


def load_fid_inception(weights_path: Optional[str] = None, batch_size: int = 128,
                       device="cuda", mesh=None):
    """Returns feature_fn: uint8/float (N, H, W, C) images → (N, 2048) f32
    numpy, computed on ``device`` (each rank its slice of a batch, with a
    data ``mesh``). Float input is taken as already in [-1, 1] (the callers'
    input_transform maps it there); grayscale is tiled to 3 channels."""
    from .device_apply import apply_batched

    model = _load_inception(weights_path, False, device)

    def feature_fn(x):
        return apply_batched(lambda b: model(b)[0][:, 0, 0, :], _images(x), batch_size, device,
                             mesh)

    return feature_fn


def load_is_inception(weights_path: Optional[str] = None, batch_size: int = 128,
                      device="cuda", mesh=None):
    """Returns prob_fn: uint8/float (N, H, W, C) images → (N, 1008) softmax
    probabilities of the release net's fc head, the marginal the Inception
    Score is computed over."""
    from .device_apply import apply_batched

    model = _load_inception(weights_path, True, device)

    def prob_fn(x):
        return apply_batched(lambda b: torch.softmax(model(b)[-1].float(), dim=-1), _images(x),
                             batch_size, device, mesh)

    return prob_fn
