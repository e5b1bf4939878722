"""Flax UNet params → the port's (reference-format) state_dict.

The inverse of ``vdiff_tpu/models/convert.py::torch_unet_to_flax``: flax
(in, out) dense kernels become torch (out, in), HWIO conv kernels become OIHW,
GroupNorm scale/bias become weight/bias. Numpy only; ``params`` is the JAX
model's param tree as nested dicts of arrays (anything ``np.asarray`` reads).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _linear(sd, prefix, p):
    sd[prefix + ".weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _norm(sd, prefix, p):
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _resblock(sd, prefix, p):
    for name in ("norm1", "norm2"):
        _norm(sd, f"{prefix}.{name}", p[name])
    for name in ("conv1", "conv2") + (("skip",) if "skip" in p else ()):
        _conv(sd, f"{prefix}.{name}", p[name])
    _linear(sd, prefix + ".fc", p["fc"])


def _attn(sd, prefix, p):
    _norm(sd, prefix + ".norm", p["norm"])
    _conv(sd, prefix + ".proj_in", p["proj_in"])
    _conv(sd, prefix + ".proj_out", p["proj_out"])


def _block(sd, prefix, p):
    """Reference ``Sequential(res, attn)`` (``.0``/``.1``) vs a bare res block."""
    if "attn" in p:
        _resblock(sd, prefix + ".0", p["res"])
        _attn(sd, prefix + ".1", p["attn"])
    else:
        _resblock(sd, prefix, p["res"])


def flax_params_to_state_dict(params: Mapping, model_cfg: Mapping) -> Dict[str, np.ndarray]:
    """``model_cfg`` holds the UNet's ``ch_multipliers`` and ``num_res_blocks``,
    ``multitags`` (default false) for a multi-tag class embedding and
    ``resample_with_res`` (default true): without it the resamplers are bare
    convs, keyed as the reference keys them (``downsamples.level_i.{nres}``,
    ``upsamples.level_i.{nres+1}.1``)."""
    levels = len(model_cfg["ch_multipliers"])
    nres = model_cfg["num_res_blocks"]
    with_res = model_cfg.get("resample_with_res", True)
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "time_embed.0", params["time_embed_1"])
    _linear(sd, "time_embed.2", params["time_embed_2"])
    if "class_embed" in params:
        # multi-tag models embed the tags with a bare Linear, class models
        # with the reference's Sequential(OneHot, Linear)
        key = "class_embed" if model_cfg.get("multitags") else "class_embed.1"
        _linear(sd, key, params["class_embed"])
    _conv(sd, "in_conv", params["in_conv"])
    for i in range(levels):
        base = f"downsamples.level_{i}"
        for j in range(nres):
            _block(sd, f"{base}.{j}", params[f"down_{i}_{j}"])
        if i != levels - 1 and with_res:
            _block(sd, f"{base}.{nres}", params[f"down_{i}_ds"])
        elif i != levels - 1:
            _conv(sd, f"{base}.{nres}", params[f"down_{i}_ds"])
    _resblock(sd, "middle.0", params["mid_res1"])
    _attn(sd, "middle.1", params["mid_attn"])
    _resblock(sd, "middle.2", params["mid_res2"])
    for i in range(levels):
        base = f"upsamples.level_{i}"
        for j in range(nres + 1):
            _block(sd, f"{base}.{j}", params[f"up_{i}_{j}"])
        if i != 0 and with_res:
            _block(sd, f"{base}.{nres + 1}", params[f"up_{i}_us"])
        elif i != 0:
            _conv(sd, f"{base}.{nres + 1}.1", params[f"up_{i}_us"])
    _norm(sd, "out_conv.0", params["out_norm"])
    _conv(sd, "out_conv.2", params["out_conv"])
    return sd
