"""Numerics: log-SNR schedules, posterior coefficients, prediction conversions.

Two halves, as in ``vdiff_tpu/ops/numerics.py``:

* **host, numpy float64** — the schedules and posterior coefficient tables
  that drive the sampling loop. This is the numpy branch of the JAX package's
  namespace-generic functions, copied verbatim in its arithmetic so the
  tables agree bit for bit.
* **device, torch** — the schedules again, for the per-example t of training
  (the JAX package's jnp branch, in the tensor's dtype), ``q_sample``, the
  ``pred_*`` conversions, ``flat_mean``/``flat_sum`` and the timestep
  embedding, on whatever device and dtype their tensors carry.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# host path: numpy float64
# ---------------------------------------------------------------------------


def _sigmoid(x):
    """Numerically stable sigmoid (numpy float64 on the host, torch on a tensor)."""
    if isinstance(x, torch.Tensor):
        return torch.sigmoid(x)
    out = np.empty_like(x, dtype=np.result_type(x, np.float64))
    x = np.asarray(x, dtype=out.dtype)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def log_sigmoid(x):
    """Stable log(sigmoid(x)) (numpy float64 on the host, torch on a tensor)."""
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.logsigmoid(x)
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < 0, x - np.log1p(np.exp(-np.abs(x))), -np.log1p(np.exp(-np.abs(x))))


def stable_log1mexp(x):
    """Numerically stable log(1 - exp(x)) for x < 0."""
    if isinstance(x, torch.Tensor):
        safe_lo = torch.where(x < -9, x, -9.0)
        safe_hi = torch.where(x < -9, -9.0, torch.clamp(x, max=-1e-20))
        return torch.where(x < -9, torch.log1p(-torch.exp(safe_lo)), torch.log(-torch.expm1(safe_hi)))
    x = np.asarray(x)
    safe_lo = np.where(x < -9, x, -9.0)
    safe_hi = np.where(x < -9, -9.0, np.minimum(x, -1e-20))
    return np.where(x < -9, np.log1p(-np.exp(safe_lo)), np.log(-np.expm1(safe_hi)))


def _logit(t):
    xp = _xp(t)
    return xp.log(t) - xp.log1p(-t)


def _xp(x):
    """torch for a tensor (device path), numpy otherwise (host path)."""
    return torch if isinstance(x, torch.Tensor) else np


#: schedule_fn(t) -> (logsnr, t_adjusted): numpy float64 for host arrays, the
#: tensor's dtype and device for a torch tensor
ScheduleFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


def get_logsnr_schedule(
    schedule: str,
    logsnr_min: float = -20.0,
    logsnr_max: float = 20.0,
    rescale: bool = False,
) -> ScheduleFn:
    """λ(t): t∈[0,1] → log-SNR with endpoint clamping; returns the pure
    ``fn(t) -> (logsnr, t_adjusted)`` (linear | sigmoid | cosine | legacy)."""
    if schedule == "legacy":
        x_from = x_max = 0.9999
        x_min = 0.98
        slope = -0.0199
        log_x_from = math.log(x_from)

        def legacy_fn(t):
            if isinstance(t, torch.Tensor):
                # the JAX package's f32 form: g(b) - g(a) for g(x) = x·ln x - x,
                # b = a + δ, as δ·ln a + a·h(δ/a) with a series for
                # h(r) = (1+r)·log1p(r) - r, free of cancellation
                delta = (x_min - x_max) * t
                r = delta / x_from
                h = r * r * (0.5 + r * (-1.0 / 6.0 + r * (1.0 / 12.0 - r / 20.0)))
                log_alpha = (1000.0 / slope) * (delta * log_x_from + x_from * h)
                return (log_alpha - stable_log1mexp(log_alpha - 1e-9)).to(t.dtype), t
            _t = np.asarray(t, dtype=np.float64)
            x_to = x_max + (x_min - x_max) * _t
            log_alpha = 1000.0 / slope * (x_to * np.log(x_to) - x_to - x_from * log_x_from + x_from)
            logsnr = log_alpha - stable_log1mexp(log_alpha - 1e-9)
            return logsnr, t

        return legacy_fn

    if schedule == "linear":
        logsnr2t = _sigmoid
        t2logsnr = _logit
    elif schedule == "sigmoid":
        logsnr_range = logsnr_max - logsnr_min

        def logsnr2t(logsnr):
            return (logsnr_max - logsnr) / logsnr_range

        def t2logsnr(t):
            return logsnr_max - t * logsnr_range

    elif schedule == "cosine":

        def logsnr2t(logsnr):
            xp = _xp(logsnr)
            return xp.arctan(xp.exp(-0.5 * logsnr)) / (0.5 * math.pi)

        def t2logsnr(t):
            xp = _xp(t)
            return -2.0 * xp.log(xp.tan(t * math.pi * 0.5))

    else:
        raise NotImplementedError(schedule)

    # a bool rescale remaps t through logsnr2t; a float one multiplies t
    rescale_factor = rescale if isinstance(rescale, float) and not isinstance(rescale, bool) else None
    t_from = float(logsnr2t(np.float64(logsnr_max)))
    t_to = float(logsnr2t(np.float64(logsnr_min)))

    def schedule_fn(t):
        device = isinstance(t, torch.Tensor)
        _t = t if device else np.asarray(t, dtype=np.float64)
        logsnr = t2logsnr(t_from + (t_to - t_from) * _t)
        t_adjusted = t
        if rescale:
            t_adjusted = logsnr2t(logsnr) if rescale_factor is None else t * rescale_factor
        if device:
            return logsnr.to(t.dtype), t_adjusted.to(t.dtype)
        return logsnr, np.asarray(t_adjusted, dtype=np.float64)

    return schedule_fn


class PosteriorCoefs(NamedTuple):
    """q(x_s | x_t, x_0): mean = mean_coef1·x_t (or eps) + mean_coef2·x_0;
    ``logvar`` is -inf for deterministic DDIM (η=0)."""

    mean_coef1: np.ndarray
    mean_coef2: np.ndarray
    logvar: np.ndarray


def _f32(x):
    return x.to(torch.float32) if isinstance(x, torch.Tensor) else x.astype(np.float32)


def logsnr_to_posterior(logsnr_s, logsnr_t, var_type: str, intp_frac=None,
                        x0eps_coef: bool = False) -> PosteriorCoefs:
    """Closed-form posterior coefficients from (λ_s, λ_t): numpy float64 on
    host arrays (the tables), float32 torch on tensors (the bpd surface, whose
    ``intp_frac`` may be a per-element tensor)."""
    xp = _xp(logsnr_s)
    if xp is np:
        logsnr_s = np.asarray(logsnr_s, dtype=np.float64)
        logsnr_t = np.asarray(logsnr_t, dtype=np.float64)

    log_alpha_st = 0.5 * (log_sigmoid(logsnr_s) - log_sigmoid(logsnr_t))
    logr = logsnr_t - logsnr_s
    log_one_minus_r = stable_log1mexp(logr)

    if x0eps_coef:
        mean_coef1 = xp.exp(0.5 * (log_sigmoid(logsnr_s) - logsnr_t) + logr)
        mean_coef2 = xp.sqrt(_sigmoid(logsnr_s))
    else:
        mean_coef1 = xp.exp(logr + log_alpha_st)
        mean_coef2 = xp.exp(log_one_minus_r + 0.5 * log_sigmoid(logsnr_s))

    if var_type == "fixed_large":
        logvar = log_one_minus_r + log_sigmoid(-logsnr_t)
    elif var_type == "fixed_small":
        logvar = log_one_minus_r + log_sigmoid(-logsnr_s)
    elif var_type == "fixed_medium":
        assert intp_frac is not None
        logvar_min = log_one_minus_r + log_sigmoid(-logsnr_s)
        logvar_max = log_one_minus_r + log_sigmoid(-logsnr_t)
        logvar = logvar_min + (logvar_max - logvar_min) * intp_frac
    else:
        raise NotImplementedError(var_type)

    return PosteriorCoefs(*(_f32(x) for x in (mean_coef1, mean_coef2, logvar)))


def logsnr_to_posterior_ddim(logsnr_s, logsnr_t, eta: float = 0.0,
                             x0eps_coef: bool = False) -> PosteriorCoefs:
    """DDIM-family posterior coefficients with η ∈ [0, 1] (host arrays or
    tensors, as :func:`logsnr_to_posterior`)."""
    xp = _xp(logsnr_s)
    if xp is np:
        logsnr_s = np.asarray(logsnr_s, dtype=np.float64)
        logsnr_t = np.asarray(logsnr_t, dtype=np.float64)

    if eta == 1.0:
        # as the JAX package (and the reference) do: x0eps_coef is not passed on
        return logsnr_to_posterior(logsnr_s, logsnr_t, "fixed_small")

    logr = logsnr_t - logsnr_s
    if eta == 0.0:
        log_one_minus_sqrt_r = stable_log1mexp(0.5 * logr)
        if x0eps_coef:
            mean_coef1 = xp.exp(0.5 * log_sigmoid(-logsnr_s))
            mean_coef2 = xp.exp(0.5 * log_sigmoid(logsnr_s))
        else:
            mean_coef1 = xp.exp(0.5 * (log_sigmoid(-logsnr_s) - log_sigmoid(-logsnr_t)))
            mean_coef2 = xp.exp(log_one_minus_sqrt_r + 0.5 * log_sigmoid(logsnr_s))
        logvar = xp.full_like(xp.asarray(mean_coef1), -math.inf)
    else:
        log_one_minus_r = stable_log1mexp(logr)
        log_eta2 = 2.0 * math.log(eta)
        logvar = log_one_minus_r + log_sigmoid(-logsnr_s) + log_eta2
        if x0eps_coef:
            mean_coef1 = xp.exp(
                0.5 * (stable_log1mexp(log_eta2 + log_one_minus_r) + log_sigmoid(-logsnr_s))
            )
            mean_coef2 = xp.exp(0.5 * log_sigmoid(logsnr_s))
        else:
            mean_coef1 = xp.exp(
                0.5
                * (
                    stable_log1mexp(log_eta2 + log_one_minus_r)
                    + log_sigmoid(-logsnr_s)
                    - log_sigmoid(-logsnr_t)
                )
            )
            mean_coef2 = xp.exp(
                stable_log1mexp(0.5 * (logr + stable_log1mexp(log_eta2 + log_one_minus_r)))
                + 0.5 * log_sigmoid(logsnr_s)
            )

    return PosteriorCoefs(*(_f32(x) for x in (mean_coef1, mean_coef2, logvar)))


# ---------------------------------------------------------------------------
# device path: torch
# ---------------------------------------------------------------------------


def pred_x0_from_eps(x_t, eps, logsnr_t):
    return x_t / torch.sqrt(torch.sigmoid(logsnr_t)) - eps * torch.exp(-0.5 * logsnr_t)


def pred_x0_from_x0eps(x_t, x0eps, logsnr_t):
    """σ-weighted blend of the direct x_0 head and the eps-derived x_0;
    ``x0eps`` stacks (x_0, eps) on the last (channel) axis, NHWC."""
    x_0, eps = x0eps.chunk(2, dim=-1)
    _x_0 = pred_x0_from_eps(x_t, eps, logsnr_t)
    return x_0 * torch.sigmoid(-logsnr_t) + _x_0 * torch.sigmoid(logsnr_t)


def pred_eps_from_x0(x_t, x_0, logsnr_t):
    return x_t / torch.sqrt(torch.sigmoid(-logsnr_t)) - x_0 * torch.exp(0.5 * logsnr_t)


def pred_v_from_x0eps(x_0, eps, logsnr_t):
    return -x_0 * torch.sqrt(torch.sigmoid(-logsnr_t)) + eps * torch.sqrt(torch.sigmoid(logsnr_t))


def pred_v_from_x0(x_t, x_0, logsnr_t):
    return x_t * torch.exp(0.5 * logsnr_t) - x_0 / torch.sqrt(torch.sigmoid(-logsnr_t))


def pred_x0_from_v(x_t, v, logsnr_t):
    return x_t * torch.sqrt(torch.sigmoid(logsnr_t)) - v * torch.sqrt(torch.sigmoid(-logsnr_t))


def pred_eps_from_v(x_t, v, logsnr_t):
    return x_t * torch.sqrt(torch.sigmoid(-logsnr_t)) + v * torch.sqrt(torch.sigmoid(logsnr_t))


def q_sample(x_0, logsnr_t, eps):
    """Forward process: x_t = √σ(λ)·x_0 + √σ(-λ)·ε."""
    return x_0 * torch.sqrt(torch.sigmoid(logsnr_t)) + eps * torch.sqrt(torch.sigmoid(-logsnr_t))


def q_mean_var(x_0, logsnr_t):
    """Mean and log-variance of q(x_t | x_0)."""
    return x_0 * torch.sqrt(torch.sigmoid(logsnr_t)), log_sigmoid(-logsnr_t)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) ‖ N(mean2, e^logvar2)) per element; the second
    pair may be Python numbers."""
    logvar2 = torch.as_tensor(logvar2, dtype=mean1.dtype, device=mean1.device)
    diff_logvar = logvar1 - logvar2
    return 0.5 * (-1.0 - diff_logvar + (mean1 - mean2) ** 2 * torch.exp(-logvar2)
                  + torch.exp(diff_logvar))


def approx_std_normal_cdf(x):
    """The standard normal CDF in the tanh approximation (the reference's,
    kept instead of an exact erf so the decoder NLL agrees with it)."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_loglik(x, means, log_scale, precision: float = 1.0 / 255,
                                cutoff=(-0.999, 0.999), tol: float = 1e-12):
    """Log-likelihood of x under the Gaussian (means, e^log_scale) integrated
    over x's 8-bit bin; the bins at the edges of [-1, 1] extend to ±∞."""
    if isinstance(cutoff, float):
        cutoff = (-cutoff, cutoff)
    x_centered = x - means
    inv_stdv = torch.exp(-log_scale)
    upper = inv_stdv * (x_centered + precision)
    cdf_upper = torch.where(x > cutoff[1], 1.0, approx_std_normal_cdf(upper))
    lower = inv_stdv * (x_centered - precision)
    cdf_lower = torch.where(x < cutoff[0], 0.0, approx_std_normal_cdf(lower))
    return torch.log(torch.clamp(cdf_upper - cdf_lower - tol, min=0.0) + tol)


def flat_mean(x: torch.Tensor, start_dim: int = 1) -> torch.Tensor:
    return x.mean(dim=tuple(range(start_dim, x.ndim)))


def flat_sum(x: torch.Tensor, start_dim: int = 1) -> torch.Tensor:
    return x.sum(dim=tuple(range(start_dim, x.ndim)))


def get_timestep_embedding(timesteps: torch.Tensor, embed_dim: int,
                           scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (fairseq convention), f32 → (B, embed_dim)."""
    timesteps = (scale * timesteps.float()).reshape(-1)
    half_dim = embed_dim // 2
    freq = math.log(10000.0) / (half_dim - 1)
    freq = torch.exp(-freq * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device))
    args = timesteps[:, None] * freq[None, :]
    embed = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embed_dim % 2 == 1:
        embed = torch.nn.functional.pad(embed, (0, 1))
    return embed
