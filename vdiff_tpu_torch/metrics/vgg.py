"""VGG16 feature extractor for Precision/Recall (counterpart of
``vdiff_tpu/metrics/vgg.py``), with torchvision's parameter names.

Standard VGG16: 13 3×3 SAME convs in blocks (64,64 / 128,128 / 256,256,256 /
512,512,512 / 512,512,512) with 2×2 max pools, then fc6 (25088→4096) → ReLU →
fc7 (4096→4096); the features are the 4096-d fc7 activations (stylegan2-ada's
``return_features=True``). Input convention (stylegan2-ada): raw images in
[0, 255], resized to 224×224 bilinearly (no antialias), minus the ImageNet
channel means ×255.

Weights: NVIDIA's TorchScript ``vgg16.pt`` (read through
``torch.jit.load(...).state_dict()``) or torchvision's ``vgg16`` state_dict,
from local files; keys outside torchvision's manifest are refused, and the
fc8 head (``classifier.6``) is dropped, as the JAX package's converter drops it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

VGG_FILENAMES = ("vgg16.pt", "vgg16-397923af.pth")
_SEARCH_DIRS = (
    "precomputed",
    os.path.expanduser("~/.cache/torch/hub"),
    os.path.expanduser("~/.cache/torch/hub/checkpoints"),
    os.path.expanduser("~/datasets"),
    ".",
)

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
_IMAGENET_MEAN_255 = (123.68, 116.779, 103.939)


class VGG16Features(nn.Module):
    """(N, H, W, 3) float raw [0, 255] → (N, 4096) fc7 features. ``features``
    and ``classifier`` index their layers as torchvision's vgg16 does, so its
    state_dict keys (less fc8) are this module's."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(25088, 4096), nn.ReLU(inplace=True),
                                        nn.Dropout(), nn.Linear(4096, 4096))
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN_255).view(1, 3, 1, 1),
                             persistent=False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .inception import resize_bilinear

        x = resize_bilinear(x.permute(0, 3, 1, 2), 224) - self.mean
        return self.classifier(self.features(x).flatten(1))  # NCHW flatten, as torch's


def vgg_state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's VGG16 params (numpy, as
    ``vdiff_tpu.metrics.vgg.convert_vgg_weights`` makes them) → torchvision
    keys (torch tensors): the converter's inverse, without fc8, which the
    converter drops."""
    from .manifests import _VGG_CONV_LAYERS

    params = variables["params"]
    sd = {}
    for ci, li in enumerate(_VGG_CONV_LAYERS):
        sd[f"features.{li}.weight"] = np.asarray(params[f"conv{ci}"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"features.{li}.bias"] = np.asarray(params[f"conv{ci}"]["bias"])
    for name, idx in (("fc6", 0), ("fc7", 3)):
        sd[f"classifier.{idx}.weight"] = np.asarray(params[name]["kernel"]).T
        sd[f"classifier.{idx}.bias"] = np.asarray(params[name]["bias"])
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def load_vgg_state_dict(model: VGG16Features, state_dict: dict) -> None:
    """Load a torchvision-layout vgg16 state_dict: keys outside the manifest
    raise, fc8 is dropped, the rest loads strictly."""
    from .manifests import vgg16_manifest

    unknown = set(state_dict) - set(vgg16_manifest())
    if unknown:
        raise KeyError(f"unexpected vgg16 state-dict keys: {sorted(unknown)[:5]}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()
                           if not k.startswith("classifier.6.")}, strict=True)


def find_vgg_weights() -> Optional[str]:
    for d in _SEARCH_DIRS:
        for f in VGG_FILENAMES:
            cand = os.path.join(d, f)
            if os.path.exists(cand):
                return cand
    return None


def load_vgg_features(weights_path: Optional[str] = None, batch_size: int = 64, device="cuda",
                      mesh=None):
    """Returns feature_fn: (N, H, W, C) uint8/float images → (N, 4096) f32
    numpy, computed on ``device`` (each rank its slice of a batch, with a
    data ``mesh``)."""
    from .device_apply import apply_batched

    weights_path = weights_path or find_vgg_weights()
    if weights_path is None:
        raise FileNotFoundError(
            f"VGG16 weights not found (looked for {VGG_FILENAMES} in {_SEARCH_DIRS}). "
            "No network egress here — place NVIDIA's vgg16.pt or torchvision's "
            "vgg16 state_dict in one of those directories."
        )
    if weights_path.endswith(".pt"):
        sd = torch.jit.load(weights_path, map_location="cpu").state_dict()
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    model = VGG16Features()
    load_vgg_state_dict(model, sd)
    model = model.to(device).eval()

    def feature_fn(x):
        x = np.asarray(x, np.float32)
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        return apply_batched(model, x, batch_size, device, mesh)

    return feature_fn
