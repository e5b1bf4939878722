"""Plain V-diffusion arithmetic of the benchmark's reference: the cosine
log-SNR schedule, the deterministic DDIM sampler with classifier-free
guidance, and the training loss, written from the published equations
(Salimans & Ho, "Progressive distillation", v-parameterisation; Nichol &
Dhariwal's improved DDPM; Ho & Salimans' classifier-free guidance) in
float64 on the host where they are tables and float32 on the device where
they act on tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _cosine_t_range(logsnr_min: float, logsnr_max: float):
    """The t interval whose cosine log-SNR spans [logsnr_min, logsnr_max]."""
    t_from = math.atan(math.exp(-0.5 * logsnr_max)) / (0.5 * math.pi)
    t_to = math.atan(math.exp(-0.5 * logsnr_min)) / (0.5 * math.pi)
    return t_from, t_to


def logsnr_cosine(t, logsnr_min: float = -20.0, logsnr_max: float = 20.0):
    """λ(t) = -2 log tan(π/2 · (t_from + (t_to - t_from)·t)): float64 numpy
    on the host, the tensor's dtype on a tensor."""
    t_from, t_to = _cosine_t_range(logsnr_min, logsnr_max)
    if isinstance(t, torch.Tensor):
        return -2.0 * torch.log(torch.tan((t_from + (t_to - t_from) * t) * math.pi * 0.5))
    t = np.asarray(t, dtype=np.float64)
    return -2.0 * np.log(np.tan((t_from + (t_to - t_from) * t) * math.pi * 0.5))


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


def ddim_table(steps: int, logsnr_min: float, logsnr_max: float) -> np.ndarray:
    """Rows i = 0..steps-1 of reverse step t = (T-i)/T → s = (T-1-i)/T:
    (model t, λ_t, c1, c2, last), with the η = 0 DDIM update
    x_s = c1·x_t + c2·x̂_0, c1 = σ_s/σ_t, c2 = α_s - c1·α_t, as float64."""
    ti = np.arange(steps - 1, -1, -1, dtype=np.float64)
    s, t = ti / steps, (ti + 1.0) / steps
    ls, lt = logsnr_cosine(s, logsnr_min, logsnr_max), logsnr_cosine(t, logsnr_min, logsnr_max)
    alpha_s, alpha_t = np.exp(0.5 * _log_sigmoid(ls)), np.exp(0.5 * _log_sigmoid(lt))
    sigma_s, sigma_t = np.exp(0.5 * _log_sigmoid(-ls)), np.exp(0.5 * _log_sigmoid(-lt))
    c1 = sigma_s / sigma_t
    c2 = alpha_s - c1 * alpha_t
    return np.stack([t, lt, c1, c2, (ti == 0).astype(np.float64)], axis=1)


def pred_x0(out: torch.Tensor, x_t: torch.Tensor, logsnr: torch.Tensor, head: str) -> torch.Tensor:
    """x̂_0 from the model output: ``v`` (x̂_0 = α x_t - σ v) or ``both``
    (channels [x_0, ε] blended as σ²·x_0 + α²·(x_t - σ ε)/α)."""
    alpha2, sigma2 = torch.sigmoid(logsnr), torch.sigmoid(-logsnr)
    if head == "v":
        return alpha2.sqrt() * x_t - sigma2.sqrt() * out
    if head == "both":
        x0, eps = out.chunk(2, dim=-1)
        return sigma2 * x0 + alpha2 * (x_t - sigma2.sqrt() * eps) / alpha2.sqrt()
    raise NotImplementedError(head)


def pred_eps(x_t: torch.Tensor, x0: torch.Tensor, logsnr: torch.Tensor) -> torch.Tensor:
    return (x_t - torch.sigmoid(logsnr).sqrt() * x0) / torch.sigmoid(-logsnr).sqrt()


def ddim_sample(model, x_T: torch.Tensor, y: Optional[torch.Tensor], steps: int, w_guide: float,
                head: str, logsnr_min: float, logsnr_max: float) -> torch.Tensor:
    """Deterministic DDIM from x_T (B, H, W, C) over ``steps`` steps with
    classifier-free guidance of weight ``w_guide`` (the model runs the
    conditional and the null label as one batch; the update and x̂_0 of the
    two are mixed as (1 + w)·cond − w·uncond). x̂_0 is clipped to [-1, 1]
    before the update; the last step returns the mixed x̂_0."""
    table = torch.as_tensor(ddim_table(steps, logsnr_min, logsnr_max), dtype=torch.float32,
                            device=x_T.device)
    B = x_T.shape[0]
    guided = w_guide > 0 and y is not None
    y_in = torch.cat([y, torch.zeros_like(y)]) if guided else y
    x = x_T
    for t, lt, c1, c2, last in table.unbind(0):
        x_in = torch.cat([x, x]) if guided else x
        out = model(x_in, t.expand(x_in.shape[0]), y_in)
        x0 = pred_x0(out, x_in, lt, head).clamp(-1.0, 1.0)
        mean = x0 if bool(last) else c1 * x_in + c2 * x0
        if guided:
            mean = (1.0 + w_guide) * mean[:B] - w_guide * mean[B:]
        x = mean
    return x


def train_loss(model, x0: torch.Tensor, y: Optional[torch.Tensor], t: torch.Tensor,
               noise: torch.Tensor, keep: Optional[torch.Tensor], head: str,
               logsnr_min: float, logsnr_max: float, dropout=None) -> torch.Tensor:
    """Per-sample loss (B,) of the ``snr_trunc`` weighting: the larger of the
    mean squared errors of x̂_0 and of ε̂. The label of a row whose ``keep`` is
    false is replaced by the null label."""
    shape = (-1,) + (1,) * (x0.ndim - 1)
    logsnr = logsnr_cosine(t, logsnr_min, logsnr_max).reshape(shape)
    x_t = torch.sigmoid(logsnr).sqrt() * x0 + torch.sigmoid(-logsnr).sqrt() * noise
    if y is not None and keep is not None:
        y = y * keep.to(y.dtype).reshape((-1,) + (1,) * (y.ndim - 1))
    out = model(x_t, t, y, dropout)
    x0_hat = pred_x0(out, x_t, logsnr, head)
    if head == "v":
        eps_hat = torch.sigmoid(-logsnr).sqrt() * x_t + torch.sigmoid(logsnr).sqrt() * out
    else:
        eps_hat = pred_eps(x_t, x0_hat, logsnr)
    dims = tuple(range(1, x0.ndim))
    return torch.maximum(((x0 - x0_hat) ** 2).mean(dim=dims),
                         ((noise - eps_hat) ** 2).mean(dim=dims))
