"""Experiment assembly for the port (counterpart of ``vdiff_tpu/factory.py``).

Experiment configs are the JAX package's JSON files, read by path from
``vdiff_tpu/configs/`` (reading JSON imports nothing of JAX). Checkpoints are
torch ``.pt`` files in the reference format.
"""

from __future__ import annotations

import json
import os
from functools import partial
from types import SimpleNamespace

import torch

from .utils.config import fill_with_defaults, update_config

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "vdiff_tpu", "configs")
DEFAULT_CONFIG_PATH = os.path.join(CONFIG_DIR, "defaults.json")


def load_experiment_config(config_path: str, default_config_path: str = DEFAULT_CONFIG_PATH):
    """Experiment JSON deep-merged over defaults → (config dict, exp name).

    An experiment whose model names ``head_dim`` and not ``num_heads`` keeps
    ``num_heads`` unset, so its head count is channels / head_dim: celeba.json's
    301.38 M-parameter model (N = 6/9/12 heads of 64), the one bench.py builds.
    The JAX package's loader merges the defaults' ``num_heads: 1`` over it and
    builds one head of 64 per block (266.8 M parameters; ROADMAP C4)."""
    with open(config_path, "r") as f:
        config = json.load(f)
    with open(default_config_path, "r") as f:
        defaults = json.load(f)
    model = config.get("model", {})
    heads_from_dim = "head_dim" in model and "num_heads" not in model
    fill_with_defaults(config, defaults)
    if heads_from_dim:
        config["model"]["num_heads"] = None
    exp_name = os.path.splitext(os.path.basename(config_path))[0]
    return config, exp_name


def heads_note(model_section: dict) -> str | None:
    """The line the CLIs print when the head count comes from ``head_dim``
    (see :func:`load_experiment_config`): the heads each attention level gets,
    and that the JAX CLIs build another model from the same file."""
    head_dim = model_section.get("head_dim")
    if head_dim is None or model_section.get("num_heads") is not None:
        return None
    hid = model_section["hid_channels"]
    heads = [hid * m // head_dim for m, attn in zip(model_section["ch_multipliers"],
                                                   model_section["apply_attn"]) if attn]
    return (f"attention: heads of {head_dim}, {heads} heads at the attention levels (num_heads "
            f"unset: channels / head_dim); the JAX CLIs build one head of {head_dim} from this "
            "config, so checkpoints do not cross between them (ROADMAP C4)")


def load_weights(model: torch.nn.Module, state_dict: dict) -> None:
    """``model.load_state_dict(state_dict, strict=True)``, refusing by name a
    checkpoint whose attention blocks have another width than the model's: one
    trained by the JAX CLIs from an experiment that sets ``head_dim`` alone
    (ROADMAP C4)."""
    own = model.state_dict()
    for key, value in state_dict.items():
        if key.endswith("proj_in.weight") and key in own and own[key].shape != value.shape:
            raise ValueError(
                f"{key}: the checkpoint's attention projects to 3x{value.shape[0] // 3} channels, "
                f"this model's to 3x{own[key].shape[0] // 3}. The port builds an experiment that "
                "sets head_dim and not num_heads with channels / head_dim heads (bench.py's "
                "model); the JAX CLIs build one head of head_dim from the same file "
                "(ROADMAP C4), and their checkpoints do not load here.")
    model.load_state_dict(state_dict, strict=True)


def resolve_section(config: dict, args, section: str, fields: dict) -> SimpleNamespace:
    """Resolve one config section against CLI args (CLI > experiment JSON >
    defaults). ``fields`` maps a config field to a spec with optional ``arg``
    (the CLI attribute when named differently) and ``op`` (the store_true
    OR/AND rule). Resolved values are written back into ``config[section]``,
    so the dumped config records what ran."""
    sec = config.setdefault(section, {})
    get = partial(update_config, old_config=sec, new_config=args)
    return SimpleNamespace(**{name: get(name, spec.get("arg"), logical_op=spec.get("op"))
                              for name, spec in fields.items()})


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
               generator: torch.Generator | None = None, model_var_type: str = "fixed_large"):
    """(resolved) ``config["model"]`` → UNet; out_channels follows the
    prediction head ("both" doubles it) and the variance ("learned" doubles
    it again: the variance logits follow the prediction on the channel axis,
    where ``GaussianDiffusion.p_mean_var`` splits them off)."""
    from .models.unet import UNet

    cfg = {k: v for k, v in model_section.items() if k != "use_xformers"}
    cfg.setdefault("in_channels", in_channels)
    assert cfg["in_channels"] == in_channels, (cfg["in_channels"], in_channels)
    head_mult = 2 if normalize_out_type(model_out_type) == "both" else 1
    head_mult *= 2 if model_var_type == "learned" else 1
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
