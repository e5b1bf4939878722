"""Expected state-dict manifests of the released metric-network weight files
(a copy of ``vdiff_tpu/metrics/manifests.py``: numpy only).

The metric stack loads two external torch weight files:

* ``pt_inception-2015-12-05-6726825d.pth`` — the pytorch-fid InceptionV3
  (torchvision inception_v3 layout, ``aux_logits=False``, 1008-class fc head).
* torchvision ``vgg16`` / NVIDIA stylegan2-ada ``vgg16.pt`` — 13 convs +
  3-layer classifier.

Neither file is in the repository, so these manifests pin the exact key names
and tensor shapes the metric nets must load: tests and ``chip_smoke.py``
synthesize state dicts from them and load them with ``strict=True``, so a
layout mismatch fails now and not on the day the files arrive.

The inception channel plan below is the InceptionV3 architecture itself
(Szegedy et al. 2015, as realized by torchvision), independent of the
modules that load it.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# FID InceptionV3 (pytorch-fid release layout)
# ---------------------------------------------------------------------------

# conv module name -> (in_ch, out_ch, kh, kw); order irrelevant (dict manifest)
_STEM = {
    "Conv2d_1a_3x3": (3, 32, 3, 3),
    "Conv2d_2a_3x3": (32, 32, 3, 3),
    "Conv2d_2b_3x3": (32, 64, 3, 3),
    "Conv2d_3b_1x1": (64, 80, 1, 1),
    "Conv2d_4a_3x3": (80, 192, 3, 3),
}


def _inception_a(in_ch, pool_ch):
    return {
        "branch1x1": (in_ch, 64, 1, 1),
        "branch5x5_1": (in_ch, 48, 1, 1),
        "branch5x5_2": (48, 64, 5, 5),
        "branch3x3dbl_1": (in_ch, 64, 1, 1),
        "branch3x3dbl_2": (64, 96, 3, 3),
        "branch3x3dbl_3": (96, 96, 3, 3),
        "branch_pool": (in_ch, pool_ch, 1, 1),
    }


def _inception_b(in_ch):
    return {
        "branch3x3": (in_ch, 384, 3, 3),
        "branch3x3dbl_1": (in_ch, 64, 1, 1),
        "branch3x3dbl_2": (64, 96, 3, 3),
        "branch3x3dbl_3": (96, 96, 3, 3),
    }


def _inception_c(in_ch, c7):
    return {
        "branch1x1": (in_ch, 192, 1, 1),
        "branch7x7_1": (in_ch, c7, 1, 1),
        "branch7x7_2": (c7, c7, 1, 7),
        "branch7x7_3": (c7, 192, 7, 1),
        "branch7x7dbl_1": (in_ch, c7, 1, 1),
        "branch7x7dbl_2": (c7, c7, 7, 1),
        "branch7x7dbl_3": (c7, c7, 1, 7),
        "branch7x7dbl_4": (c7, c7, 7, 1),
        "branch7x7dbl_5": (c7, 192, 1, 7),
        "branch_pool": (in_ch, 192, 1, 1),
    }


def _inception_d(in_ch):
    return {
        "branch3x3_1": (in_ch, 192, 1, 1),
        "branch3x3_2": (192, 320, 3, 3),
        "branch7x7x3_1": (in_ch, 192, 1, 1),
        "branch7x7x3_2": (192, 192, 1, 7),
        "branch7x7x3_3": (192, 192, 7, 1),
        "branch7x7x3_4": (192, 192, 3, 3),
    }


def _inception_e(in_ch):
    return {
        "branch1x1": (in_ch, 320, 1, 1),
        "branch3x3_1": (in_ch, 384, 1, 1),
        "branch3x3_2a": (384, 384, 1, 3),
        "branch3x3_2b": (384, 384, 3, 1),
        "branch3x3dbl_1": (in_ch, 448, 1, 1),
        "branch3x3dbl_2": (448, 384, 3, 3),
        "branch3x3dbl_3a": (384, 384, 1, 3),
        "branch3x3dbl_3b": (384, 384, 3, 1),
        "branch_pool": (in_ch, 192, 1, 1),
    }


def inception_conv_plan() -> dict:
    """{'Mixed_5b.branch1x1': (in, out, kh, kw), ...} for every BasicConv2d."""
    plan = {name: spec for name, spec in _STEM.items()}
    blocks = {
        "Mixed_5b": _inception_a(192, 32),
        "Mixed_5c": _inception_a(256, 64),
        "Mixed_5d": _inception_a(288, 64),
        "Mixed_6a": _inception_b(288),
        "Mixed_6b": _inception_c(768, 128),
        "Mixed_6c": _inception_c(768, 160),
        "Mixed_6d": _inception_c(768, 160),
        "Mixed_6e": _inception_c(768, 192),
        "Mixed_7a": _inception_d(768),
        "Mixed_7b": _inception_e(1280),
        "Mixed_7c": _inception_e(2048),
    }
    for block, convs in blocks.items():
        for branch, spec in convs.items():
            plan[f"{block}.{branch}"] = spec
    return plan


def fid_inception_manifest(include_num_batches_tracked: bool = True) -> dict:
    """{state-dict key: shape tuple} of the pytorch-fid release file."""
    manifest = {}
    for mod, (cin, cout, kh, kw) in inception_conv_plan().items():
        manifest[f"{mod}.conv.weight"] = (cout, cin, kh, kw)
        manifest[f"{mod}.bn.weight"] = (cout,)
        manifest[f"{mod}.bn.bias"] = (cout,)
        manifest[f"{mod}.bn.running_mean"] = (cout,)
        manifest[f"{mod}.bn.running_var"] = (cout,)
        if include_num_batches_tracked:
            manifest[f"{mod}.bn.num_batches_tracked"] = ()
    manifest["fc.weight"] = (1008, 2048)
    manifest["fc.bias"] = (1008,)
    return manifest


# ---------------------------------------------------------------------------
# VGG16 (torchvision layout; the NVIDIA TorchScript file exposes the same
# parameter names through Module.state_dict())
# ---------------------------------------------------------------------------

_VGG_CONV_LAYERS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_CONV_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


def vgg16_manifest() -> dict:
    """{state-dict key: shape tuple} of torchvision vgg16."""
    manifest = {}
    cin = 3
    for li, cout in zip(_VGG_CONV_LAYERS, _VGG_CONV_CHANNELS):
        manifest[f"features.{li}.weight"] = (cout, cin, 3, 3)
        manifest[f"features.{li}.bias"] = (cout,)
        cin = cout
    manifest["classifier.0.weight"] = (4096, 25088)
    manifest["classifier.0.bias"] = (4096,)
    manifest["classifier.3.weight"] = (4096, 4096)
    manifest["classifier.3.bias"] = (4096,)
    manifest["classifier.6.weight"] = (1000, 4096)
    manifest["classifier.6.bias"] = (1000,)
    return manifest


def synth_state_dict(manifest: dict, seed: int = 0) -> dict:
    """Small random numpy tensors in the manifest's exact keys/shapes.

    BatchNorm running_var entries are kept positive (the net divides by
    sqrt(var + eps))."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape in manifest.items():
        if key.endswith("num_batches_tracked"):
            sd[key] = np.asarray(0, np.int64)
        elif key.endswith("running_var"):
            sd[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[key] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return sd


def he_rescaled(sd: dict) -> dict:
    """``sd`` with its signal kept through depth: every weight of rank ≥ 2
    rescaled to He's scale, N(0, 2 / fan_in), and every BatchNorm scale moved
    to 1 + N(0, 0.05). Through :func:`synth_state_dict`'s N(0, 0.05)
    weights a deep net's output stops depending on its input (the Inception's
    pool3 features come out equal to the last bit for any two images, its IS
    probabilities too) or blows up (VGG16's fc7 reaches ~1e6, past float16's
    65,504, in which Precision/Recall stores features, as the reference
    does); rescaled, features differ from image to image and fc7 stays in
    the hundreds, as a trained net's would."""
    out = dict(sd)
    for key, v in sd.items():
        v = np.asarray(v)
        if key.endswith("bn.weight"):
            out[key] = (v + 1.0).astype(v.dtype)
        elif key.endswith("weight") and v.ndim >= 2:
            fan_in = int(np.prod(v.shape[1:]))
            out[key] = (v * (np.sqrt(2.0 / fan_in) / 0.05)).astype(v.dtype)
    return out
