"""Experiment assembly for the port (counterpart of ``vdiff_tpu/factory.py``).

Experiment configs are the JAX package's JSON files, read by path from
``vdiff_tpu/configs/`` (reading JSON imports nothing of JAX). Checkpoints are
torch ``.pt`` files in the reference format.
"""

from __future__ import annotations

import json
import os

import torch

from .utils.config import fill_with_defaults

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "vdiff_tpu", "configs")
DEFAULT_CONFIG_PATH = os.path.join(CONFIG_DIR, "defaults.json")


def load_experiment_config(config_path: str, default_config_path: str = DEFAULT_CONFIG_PATH):
    """Experiment JSON deep-merged over defaults → (config dict, exp name)."""
    with open(config_path, "r") as f:
        config = json.load(f)
    with open(default_config_path, "r") as f:
        defaults = json.load(f)
    fill_with_defaults(config, defaults)
    exp_name = os.path.splitext(os.path.basename(config_path))[0]
    return config, exp_name


def normalize_out_type(model_out_type: str) -> str:
    """The reference CLI spells the x0 head "x_0"; configs use "x0"."""
    return "x0" if model_out_type == "x_0" else model_out_type


def build_diffusion(diff_section: dict, *, w_guide: float, p_uncond: float = 0.0,
                    sample_timesteps: int | None = None, continuous_gate: bool = True):
    """(resolved) ``config["diffusion"]`` → (GaussianDiffusion, train_timesteps).
    With ``continuous_gate`` (training) the rescale applies only to continuous
    training (train_timesteps == 0); without it (sampling) ``allow_rescale``
    applies directly."""
    from .diffusion import GaussianDiffusion
    from .ops.numerics import get_logsnr_schedule

    d = dict(diff_section)
    train_timesteps = d.pop("train_timesteps", None)
    allow_rescale = d.pop("allow_rescale", False)
    rescale = allow_rescale and (train_timesteps == 0 or not continuous_gate)
    logsnr_fn = get_logsnr_schedule(
        d.pop("logsnr_schedule"),
        logsnr_min=d.pop("logsnr_min"),
        logsnr_max=d.pop("logsnr_max"),
        rescale=rescale,
    )
    if sample_timesteps is not None:
        d["sample_timesteps"] = sample_timesteps
    d["model_out_type"] = normalize_out_type(d.get("model_out_type", "eps"))
    diffusion = GaussianDiffusion(logsnr_fn=logsnr_fn, w_guide=w_guide, p_uncond=p_uncond, **d)
    return diffusion, train_timesteps


def build_unet(model_section: dict, *, in_channels: int, model_out_type: str,
               num_classes: int, multitags: bool, dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None):
    """(resolved) ``config["model"]`` → UNet; out_channels follows the
    prediction head ("both" doubles it)."""
    from .models.unet import UNet

    cfg = {k: v for k, v in model_section.items() if k != "use_xformers"}
    cfg.setdefault("in_channels", in_channels)
    assert cfg["in_channels"] == in_channels, (cfg["in_channels"], in_channels)
    head_mult = 2 if normalize_out_type(model_out_type) == "both" else 1
    cfg.setdefault("out_channels", head_mult * in_channels)
    return UNet(num_classes=num_classes, multitags=multitags, dtype=dtype,
                generator=generator, **cfg)


def load_checkpoint_params(ckpt_path: str, use_ema: bool = False):
    """Load denoiser weights from a reference-format torch ``.pt`` file
    (``{"model": sd, "ema": {"shadow": sd}}``).

    Returns ``(state_dict, head_keys)``; ``head_keys`` (top-level module
    names) tell a conditional model by its ``class_embed``."""
    if os.path.isdir(ckpt_path):
        raise NotImplementedError(
            f"'{ckpt_path}' is an Orbax checkpoint directory; the port loads torch .pt "
            "files only (an Orbax→.pt export is a later item of ROADMAP.md queue A)"
        )
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state_dict = ckpt["ema"]["shadow"] if use_ema else ckpt["model"]
    state_dict = {(k.split(".", 1)[1] if k.startswith("module.") else k): v
                  for k, v in state_dict.items()}
    return state_dict, {k.split(".")[0] for k in state_dict}
