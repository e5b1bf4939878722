"""Gaussian V-diffusion, sampling half (counterpart of ``vdiff_tpu/diffusion.py``).

Per-step schedule and posterior scalars are precomputed on the host in numpy
float64 and cast to float32 (:meth:`GaussianDiffusion.sample_tables`), exactly
as the JAX package does. The reverse process is a Python loop over the table
rows on the device. Classifier-free guidance doubles the batch as
concatenated halves [cond; uncond]. Randomness is explicit: the caller passes
``x_T`` and, for ancestral or η>0 DDIM sampling, a ``torch.Generator``;
deterministic DDIM (η=0) draws no noise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .ops import numerics as N


@dataclass(frozen=True)
class GaussianDiffusion:
    """Hyperparameters of the diffusion process; ``logsnr_fn`` is a host
    schedule from :func:`vdiff_tpu_torch.ops.numerics.get_logsnr_schedule`."""

    logsnr_fn: Callable = field(hash=False)
    sample_timesteps: int = 256
    model_out_type: str = "eps"  # x0 | eps | both | v
    model_var_type: str = "fixed_large"  # fixed_large | fixed_small | fixed_medium | learned
    reweight_type: str = "snr"
    loss_type: str = "mse"
    intp_frac: Optional[float] = None
    w_guide: float = 0.1
    p_uncond: float = 0.1
    x0eps_coef: bool = False

    def pred_x0(self, model_out, x_t, logsnr_t):
        """Model output → x̂_0 for this model's head type."""
        if self.model_out_type == "x0":
            return model_out
        if self.model_out_type == "eps":
            return N.pred_x0_from_eps(x_t, model_out, logsnr_t)
        if self.model_out_type == "both":
            return N.pred_x0_from_x0eps(x_t, model_out, logsnr_t)
        if self.model_out_type == "v":
            return N.pred_x0_from_v(x_t, model_out, logsnr_t)
        raise NotImplementedError(self.model_out_type)

    def sample_tables(self, use_ddim: bool = False, eta: float = 0.0) -> Dict[str, np.ndarray]:
        """Per-step scalars, host float64 math, float32 (T,) arrays. Row ``i``
        is reverse step ti = T-1-i. ``eta`` is the DDIM noise level (0
        deterministic, 1 ≡ ancestral fixed_small); ignored without DDIM."""
        T = self.sample_timesteps
        ti = np.arange(T - 1, -1, -1, dtype=np.float64)
        s = ti / T
        t = (ti + 1.0) / T
        logsnr_s, _ = self.logsnr_fn(s)
        logsnr_t, model_t = self.logsnr_fn(t)

        if use_ddim:
            coefs = N.logsnr_to_posterior_ddim(logsnr_s, logsnr_t, eta=eta, x0eps_coef=self.x0eps_coef)
        else:
            var_type, intp = self.model_var_type, self.intp_frac
            if var_type == "learned":
                var_type, intp = "fixed_medium", 0.5  # placeholder; learned lerps per element
            coefs = N.logsnr_to_posterior(logsnr_s, logsnr_t, var_type=var_type, intp_frac=intp,
                                          x0eps_coef=self.x0eps_coef)
        small = N.logsnr_to_posterior(logsnr_s, logsnr_t, "fixed_small")
        large = N.logsnr_to_posterior(logsnr_s, logsnr_t, "fixed_large")

        with np.errstate(over="ignore"):  # exp(-inf) -> 0 for ddim
            sigma = np.exp(0.5 * coefs.logvar.astype(np.float64)).astype(np.float32)

        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return {
            "model_t": f32(model_t),
            "logsnr_s": f32(logsnr_s),
            "logsnr_t": f32(logsnr_t),
            "mean_coef1": f32(coefs.mean_coef1),
            "mean_coef2": f32(coefs.mean_coef2),
            "sigma": f32(sigma),
            "logvar_min": f32(small.logvar),
            "logvar_max": f32(large.logvar),
            "nonzero": f32(ti > 0),
        }

    def _p_sample_step(self, denoise_fn, x_t, row, y, noise, clip_denoised=True, use_ddim=False):
        """One reverse step from a table row (dict of 0-d float32 tensors on
        x_t's device). ``noise=None`` skips the noise term (DDIM η=0).
        Returns (x_s, x̂_0)."""
        B = x_t.shape[0]
        use_cfg = self.w_guide > 0 and y is not None
        if use_cfg:
            x_in = torch.cat([x_t, x_t], dim=0)
            y_in = torch.cat([y, torch.zeros_like(y)], dim=0)
        else:
            x_in, y_in = x_t, y

        t_in = row["model_t"].to(x_t.dtype).expand(x_in.shape[0])
        model_out = denoise_fn(x_in, t_in, y_in)

        intp_frac = None
        if self.model_var_type == "learned":
            model_out, frac_raw = model_out.chunk(2, dim=-1)
            intp_frac = torch.sigmoid(frac_raw)

        logsnr_t = row["logsnr_t"]
        pred_x_0 = self.pred_x0(model_out, x_in, logsnr_t)
        if clip_denoised:
            pred_x_0 = pred_x_0.clamp(-1.0, 1.0)

        base = x_in
        if self.x0eps_coef:
            if clip_denoised or self.model_out_type != "eps":
                base = N.pred_eps_from_x0(x_in, pred_x_0, logsnr_t)
            else:
                base = model_out

        mean = row["mean_coef1"] * base + row["mean_coef2"] * pred_x_0
        sigma = row["sigma"]
        if intp_frac is not None and use_ddim:
            intp_frac = None  # the DDIM posterior is deterministic
        if intp_frac is not None:
            logvar = row["logvar_min"] + (row["logvar_max"] - row["logvar_min"]) * intp_frac
            sigma = torch.exp(0.5 * logvar)

        cond = row["nonzero"]
        mean = cond * mean + (1.0 - cond) * pred_x_0

        if use_cfg:
            mean_c, mean_u = mean[:B], mean[B:]
            p_c, p_u = pred_x_0[:B], pred_x_0[B:]
            mean = mean_c + self.w_guide * (mean_c - mean_u)
            pred_x_0 = p_c + self.w_guide * (p_c - p_u)
            if intp_frac is not None:
                sigma = sigma[:B]

        sample = mean if noise is None else mean + cond * sigma * noise
        return sample, pred_x_0

    def p_sample(self, denoise_fn, x_T: torch.Tensor, label=None, use_ddim: bool = False,
                 clip_denoised: bool = True, eta: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """All T reverse steps from ``x_T`` (B, H, W, C). ``generator`` draws
        the per-step noise; it is required unless DDIM with η=0."""
        deterministic = use_ddim and eta == 0.0
        if not deterministic and generator is None:
            raise ValueError("ancestral / eta>0 sampling needs an explicit torch.Generator")
        tables = {k: torch.as_tensor(v, device=x_T.device)
                  for k, v in self.sample_tables(use_ddim=use_ddim, eta=eta).items()}
        x = x_T
        for i in range(self.sample_timesteps):
            row = {k: v[i] for k, v in tables.items()}
            noise = None if deterministic else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x, _ = self._p_sample_step(denoise_fn, x, row, label, noise,
                                       clip_denoised=clip_denoised, use_ddim=use_ddim)
        return x
