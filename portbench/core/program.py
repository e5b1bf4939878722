"""The system under test: ``vdiff_tpu_torch``, driven as its CLIs drive it.

This is the one module of the benchmark that imports the program. It takes
the benchmark's configuration, weights and inputs and gives back the
program's sampler call and train step, nothing of the program's own
configuration files or initialisation.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import torch


def build_model(config: dict, weights: Dict[str, torch.Tensor], dtype: torch.dtype, device):
    """The port's UNet of the configuration, built without initialising
    (on the meta device), then given ``weights``."""
    from vdiff_tpu_torch.factory import build_unet

    data, diff = config["data"], config["diffusion"]
    with torch.device("meta"):
        model = build_unet(dict(config["model"]), in_channels=data["channels"],
                           model_out_type=diff["model_out_type"],
                           num_classes=data.get("num_classes", 0),
                           multitags=data.get("multitags", False), dtype=dtype,
                           model_var_type=diff["model_var_type"])
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def build_diffusion(config: dict, sampling: bool, steps: int = None, w_guide: float = 0.0):
    from vdiff_tpu_torch.factory import build_diffusion as build

    cond = config["conditional"]
    diffusion, _ = build(config["diffusion"], w_guide=w_guide,
                         p_uncond=0.0 if sampling else cond["p_uncond"],
                         sample_timesteps=steps, continuous_gate=not sampling)
    return diffusion


class Sampler:
    """``generate.py``'s call: ``p_sample`` with DDIM, η = 0, the CUDA graph,
    guided with weight ``w_guide`` (none at 0)."""

    def __init__(self, config: dict, model, steps: int, w_guide: float):
        self.model = model
        self.diffusion = build_diffusion(config, sampling=True, steps=steps, w_guide=w_guide)
        self.stats = {}

    def run(self, x_T: torch.Tensor, y: torch.Tensor, diffusion=None,
            graph: bool = True) -> torch.Tensor:
        return (diffusion or self.diffusion).p_sample(
            self.model, x_T, label=y, use_ddim=True, eta=0.0, graph=graph, stats=self.stats)

    def with_steps(self, steps: int):
        return dataclasses.replace(self.diffusion, sample_timesteps=steps)


class Trainer:
    """``make_train_step`` with the train CLI's optimizer and EMA, called as
    ``Trainer.step`` calls it, with the benchmark's draws handed in. The
    optimizer's count of updates starts at ``first_step`` (its learning-rate
    schedule as resumed there; AdamW's moments and bias corrections fresh)."""

    def __init__(self, config: dict, model, train_seed: int, first_step: int):
        from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

        tr = config["train"]
        self.model, self.train_seed = model, train_seed
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.optimizer = Optimizer(model.parameters(), lr=tr["lr"], beta1=tr["beta1"],
                                   beta2=tr["beta2"], weight_decay=tr["weight_decay"],
                                   warmup=tr["warmup"], grad_norm=tr["grad_norm"])
        self.optimizer.count = first_step
        diffusion = build_diffusion(config, sampling=False)
        self.step_fn = make_train_step(model, diffusion, self.optimizer,
                                       config["diffusion"]["train_timesteps"], use_cfg=True,
                                       ema_decay=tr["ema_decay"], ema_model=self.ema)
        self.beta1 = tr["beta1"]

    def run(self, batch: dict, step: int) -> torch.Tensor:
        draws = [{"t": batch["t"], "noise": batch["noise"], "keep": batch["keep"]}]
        return self.step_fn(batch["x"], batch["y"], self.train_seed, step, draws=draws)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def ema_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.ema.named_parameters())

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The clipped gradient of the first step, from AdamW's first moment
        after it: m = (1 - β1)·g."""
        state = self.optimizer.adamw.state
        return {k: state[p]["exp_avg"] / (1.0 - self.beta1) if p in state else torch.zeros_like(p)
                for k, p in self.model.named_parameters()}
