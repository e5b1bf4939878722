"""Gaussian V-diffusion: the sampler and the training loss (counterpart of
``vdiff_tpu/diffusion.py``).

Per-step schedule and posterior scalars are precomputed on the host in numpy
float64 and cast to float32 (:meth:`GaussianDiffusion.sample_tables`), exactly
as the JAX package does. The reverse process runs the step once per table
row: on a CUDA device the first step eagerly, then the step captured as one
CUDA graph and replayed for the rest (the port's counterpart of the JAX
package's jitted ``lax.scan``); on the CPU, or with ``graph=False``, a
Python loop. Classifier-free guidance doubles the batch as concatenated
halves [cond; uncond]. Randomness is explicit: the caller passes
``x_T`` and, for ancestral or η>0 DDIM sampling, a ``torch.Generator``;
deterministic DDIM (η=0) draws no noise. A rank that samples its rows of a
batch split over ranks (``batch_rows``) draws each step's noise for the
whole batch and keeps its rows, so the split run draws what one process
drawing the whole batch does.

The training loss (:meth:`GaussianDiffusion.train_loss`, ``mse`` or ``kl``)
evaluates the schedule on the device for the per-example t, in f32, as the JAX
package does. Its t, noise and CFG keep mask are passed in; the train step
draws them. The bits/dim surface (:meth:`GaussianDiffusion.calc_all_bpd`, the
eval CLI's ``nll``) runs the posterior on the device the same way, one
denoiser forward per step with its noise from an explicit generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .ops import launch_counts
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

    def t2logsnr(self, t: torch.Tensor, ndim: int = 4):
        """Device path: (B,) t → ((B,1,..) logsnr, (B,) adjusted t)."""
        logsnr, t_adj = self.logsnr_fn(t)
        return logsnr.reshape((-1,) + (1,) * (ndim - 1)), t_adj

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

    def from_model_out_to_pred(self, x_t, model_out, logsnr_t):
        """{x_0, eps, (x_0, eps), v} from any head type, keyed by the reweight
        type that compares against each."""
        assert self.model_out_type in {"x0", "eps", "both", "v"}
        if self.model_out_type == "v":
            v = model_out
            x_0 = N.pred_x0_from_v(x_t, v, logsnr_t)
            eps = N.pred_eps_from_v(x_t, v, logsnr_t)
        else:
            if self.model_out_type == "x0":
                x_0 = model_out
                eps = N.pred_eps_from_x0(x_t, x_0, logsnr_t)
            elif self.model_out_type == "eps":
                eps = model_out
                x_0 = N.pred_x0_from_eps(x_t, eps, logsnr_t)
            else:  # both
                x_0 = N.pred_x0_from_x0eps(x_t, model_out, logsnr_t)
                eps = N.pred_eps_from_x0(x_t, x_0, logsnr_t)
            v = N.pred_v_from_x0eps(x_0, eps, logsnr_t)
        return {"constant": x_0, "snr": eps, "snr_trunc": (x_0, eps), "snr_1plus": v}

    def train_loss(self, denoise_fn, x_0, t, y, noise,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-sample loss (B,). CFG label dropout zeroes the labels where
        ``keep`` (bool (B,), the JAX package's U(0,1) > p_uncond) is false;
        without ``keep`` the labels stay.

        ``loss_type="kl"`` quantises t to ceil(t·T)/T (T the sampling steps)
        and takes s = t − 1/T: the loss is the bits/dim KL of the step s ← t
        where s > 0 and the decoder's NLL at the first step."""
        ndim = x_0.ndim
        if self.loss_type == "kl":
            T = self.sample_timesteps
            t = torch.ceil(t * T) / T
            s = torch.clamp(t - 1.0 / T, min=0.0)
        elif self.loss_type != "mse":
            raise NotImplementedError(self.loss_type)
        logsnr_t, t_adj = self.t2logsnr(t, ndim)
        x_t = N.q_sample(x_0, logsnr_t, noise)

        if self.p_uncond and y is not None and keep is not None:
            y = y * keep.to(y.dtype).reshape((-1,) + (1,) * (y.ndim - 1))

        model_out = denoise_fn(x_t, t_adj, y)
        if self.loss_type == "kl":
            logsnr_s, _ = self.t2logsnr(s, ndim)
            kl, nll, _ = self._loss_term_bpd(model_out, x_0=x_0, x_t=x_t, logsnr_s=logsnr_s,
                                             logsnr_t=logsnr_t, clip_denoised=False)
            return torch.where(s != 0, kl, nll)

        assert self.model_var_type != "learned"
        assert self.reweight_type in {"constant", "snr", "snr_trunc", "snr_1plus"}
        target = {
            "constant": x_0,
            "snr": noise,
            "snr_trunc": (x_0, noise),
            "snr_1plus": N.pred_v_from_x0eps(x_0, noise, logsnr_t),
        }[self.reweight_type]
        if isinstance(target, tuple):
            # snr_trunc: elementwise max of the two flat-mean MSEs
            predict = self.from_model_out_to_pred(x_t, model_out, logsnr_t)[self.reweight_type]
            return torch.maximum(*[N.flat_mean((tgt - pred) ** 2)
                                   for tgt, pred in zip(target, predict)])
        # the other targets compare against the raw model output: the head
        # type must pair with the reweight type
        return N.flat_mean((target - model_out) ** 2)

    # the posterior on the device, for the kl loss and the bits/dim

    def q_posterior_mean_var(self, x_0, x_t, logsnr_s, logsnr_t, model_var_type=None,
                             intp_frac=None):
        """Mean and log-variance of q(x_s | x_t, x_0); ``intp_frac`` (a number
        or a per-element tensor) defaults to the diffusion's."""
        model_var_type = model_var_type or self.model_var_type
        if intp_frac is None:
            intp_frac = self.intp_frac
        coefs = N.logsnr_to_posterior(logsnr_s, logsnr_t, var_type=model_var_type,
                                      intp_frac=intp_frac, x0eps_coef=self.x0eps_coef)
        return coefs.mean_coef1 * x_t + coefs.mean_coef2 * x_0, coefs.logvar

    def q_posterior_mean_var_ddim(self, x_0, x_t, logsnr_s, logsnr_t):
        """The deterministic (η=0) DDIM posterior."""
        coefs = N.logsnr_to_posterior_ddim(logsnr_s, logsnr_t, eta=0.0, x0eps_coef=self.x0eps_coef)
        return coefs.mean_coef1 * x_t + coefs.mean_coef2 * x_0, coefs.logvar

    def p_mean_var(self, model_out, x_t, logsnr_s, logsnr_t, clip_denoised, use_ddim=False):
        """(mean, log-variance, x̂_0) of p(x_s | x_t) from a model output. A
        learned-variance model's output stacks (prediction, variance logit)
        on the last (channel) axis of its NHWC output; the logit's sigmoid
        interpolates the log-variance between fixed_small and fixed_large."""
        intp_frac = None
        if self.model_var_type == "learned":
            model_out, frac_raw = model_out.chunk(2, dim=-1)
            intp_frac = torch.sigmoid(frac_raw)

        pred_x_0 = self.pred_x0(model_out, x_t, logsnr_t)
        if clip_denoised:
            pred_x_0 = pred_x_0.clamp(-1.0, 1.0)

        if self.x0eps_coef:
            # the posterior mean in terms of (eps, x_0): eps takes x_t's place
            if clip_denoised or self.model_out_type != "eps":
                x_t = N.pred_eps_from_x0(x_t, pred_x_0, logsnr_t)
            else:
                x_t = model_out

        if use_ddim:
            mean, logvar = self.q_posterior_mean_var_ddim(pred_x_0, x_t, logsnr_s, logsnr_t)
        else:
            mean, logvar = self.q_posterior_mean_var(
                pred_x_0, x_t, logsnr_s, logsnr_t,
                model_var_type="fixed_medium" if intp_frac is not None else None,
                intp_frac=intp_frac)
        return mean, logvar, pred_x_0

    # bits per dimension

    def _loss_term_bpd(self, model_out, x_0, x_t, logsnr_s, logsnr_t, clip_denoised):
        """(KL of the step s ← t, the decoder's NLL, x̂_0), each (B,) in
        bits/dim but x̂_0."""
        true_mean, true_logvar = self.q_posterior_mean_var(
            x_0=x_0, x_t=x_t, logsnr_s=logsnr_s, logsnr_t=logsnr_t, model_var_type="fixed_small")
        model_mean, model_logvar, pred_x_0 = self.p_mean_var(
            model_out, x_t=x_t, logsnr_s=logsnr_s, logsnr_t=logsnr_t,
            clip_denoised=clip_denoised, use_ddim=False)
        kl = N.flat_mean(N.normal_kl(true_mean, true_logvar, model_mean, model_logvar))
        decoder_nll = -N.discretized_gaussian_loglik(x_0, pred_x_0, log_scale=0.5 * model_logvar)
        return kl / math.log(2.0), N.flat_mean(decoder_nll) / math.log(2.0), pred_x_0

    def _prior_bpd(self, x_0):
        """KL(q(x_1 | x_0) ‖ N(0, I)) in bits/dim, (B,)."""
        t = torch.ones(x_0.shape[0], dtype=torch.float32, device=x_0.device)
        logsnr_t, _ = self.t2logsnr(t, x_0.ndim)
        mean, logvar = N.q_mean_var(x_0=x_0, logsnr_t=logsnr_t)
        return N.flat_mean(N.normal_kl(mean, logvar, 0.0, 0.0)) / math.log(2.0)

    @torch.inference_mode()
    def calc_all_bpd(self, denoise_fn, x_0, y=None, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, clip_denoised: bool = True,
                     batch_rows: Optional[Tuple[int, int]] = None):
        """The variational bound in bits/dim over all T steps: (total (B,),
        loss (B, T), prior (B,), mse (B, T)), column i of loss and mse the
        step s = i/T ← t = (i+1)/T, as JAX's ``calc_all_bpd`` returns them.

        The steps run from i = T−1 down to 0, each one denoiser forward of
        x_t = q_sample(x_0, λ_t, eps) with eps drawn from ``generator`` in
        that order, or taken from ``noise`` (T, B, ...), row k for i = T−1−k
        (JAX's scan order: its keys[k] drive step T−1−k). Step 0 counts the
        decoder's NLL, the others the KL of their posterior. ``batch_rows``
        (start, total): x_0 holds rows from ``start`` of a batch of ``total``,
        whose noise is drawn whole and these rows kept (:func:`draw_rows`)."""
        B, T = x_0.shape[0], self.sample_timesteps
        if noise is None and generator is None:
            raise ValueError("calc_all_bpd needs an explicit torch.Generator or the noise")
        loss, mse = torch.empty(B, T, device=x_0.device), torch.empty(B, T, device=x_0.device)
        for k, i in enumerate(range(T - 1, -1, -1)):
            s = torch.full((B,), i / T, dtype=torch.float32, device=x_0.device)
            t = torch.full((B,), (i + 1.0) / T, dtype=torch.float32, device=x_0.device)
            logsnr_s, _ = self.t2logsnr(s, x_0.ndim)
            logsnr_t, t_adj = self.t2logsnr(t, x_0.ndim)
            eps = noise[k] if noise is not None else draw_rows(
                x_0.shape, generator, x_0.device, x_0.dtype, batch_rows)
            x_t = N.q_sample(x_0, logsnr_t, eps)
            model_out = denoise_fn(x_t, t_adj, y)
            kl, nll, pred_x_0 = self._loss_term_bpd(model_out, x_0, x_t=x_t, logsnr_s=logsnr_s,
                                                    logsnr_t=logsnr_t, clip_denoised=clip_denoised)
            loss[:, i] = kl if i > 0 else nll
            mse[:, i] = N.flat_mean((pred_x_0 - x_0) ** 2)
        prior_bpd = self._prior_bpd(x_0)
        return loss.sum(dim=1) + prior_bpd, loss, prior_bpd, mse

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
                 generator: Optional[torch.Generator] = None, graph: bool = True,
                 stats: Optional[dict] = None,
                 batch_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """All T reverse steps from ``x_T`` (B, H, W, C). ``generator`` draws
        the per-step noise; it is required unless DDIM with η=0.
        ``batch_rows`` (start, total) says that ``x_T`` is rows from
        ``start`` of a batch of ``total`` split over ranks: each step's noise
        is drawn for the whole batch and these rows kept (rows past
        ``total``, a padding, get none).

        On a CUDA ``x_T`` the steps after the first replay one CUDA graph of
        the step, captured in this call (:meth:`_graph_steps`); ``graph=False``,
        or a CPU ``x_T``, runs the eager loop. ``stats``, where given, is
        updated with what ran (:meth:`_reverse`)."""
        x, _ = self._reverse(denoise_fn, x_T, label, use_ddim, clip_denoised, eta, generator,
                             graph, stats, snapshot_rows=(), batch_rows=batch_rows)
        return x

    def p_sample_progressive(self, denoise_fn, x_T: torch.Tensor, label=None,
                             use_ddim: bool = False, pred_freq: int = 50, eta: float = 0.0,
                             generator: Optional[torch.Generator] = None, graph: bool = True,
                             stats: Optional[dict] = None):
        """:meth:`p_sample` that also returns x̂_0 snapshots: (x_0, (L, B, H,
        W, C)) with L = T // pred_freq, the most denoised first, as JAX's
        ``p_sample_progressive`` returns them. The ``T % pred_freq`` leading
        steps take no snapshot; after them the first step of every run of
        ``pred_freq`` does (reverse steps ti with (ti + 1) % pred_freq == 0)."""
        T = self.sample_timesteps
        head = T % pred_freq
        rows = range(head, T, pred_freq)
        x, snaps = self._reverse(denoise_fn, x_T, label, use_ddim, True, eta, generator, graph,
                                 stats, snapshot_rows=rows)
        if not snaps:
            return x, x.new_empty((0,) + tuple(x.shape))
        return x, torch.stack(snaps[::-1])

    def _reverse(self, denoise_fn, x_T, label, use_ddim, clip_denoised, eta, generator, graph,
                 stats, snapshot_rows, batch_rows=None):
        """The reverse process under ``torch.inference_mode``; returns (x_0,
        the x̂_0 of the table rows in ``snapshot_rows``). ``stats`` gets, added
        to what it holds: ``eager_steps``, ``captures`` and ``replays``;
        ``launches``, each kernel wrapper's launches on the device (the eager
        steps' plus the replays'); ``captured_launches``, the wrappers' counts
        during the captures, which launch nothing; ``replayed_launches``, the
        launches of the replays, which the wrappers do not count. So the
        device ran the wrappers' counts less ``captured_launches`` plus
        ``replayed_launches``."""
        deterministic = use_ddim and eta == 0.0
        if not deterministic and generator is None:
            raise ValueError("ancestral / eta>0 sampling needs an explicit torch.Generator")
        tables = self.sample_tables(use_ddim=use_ddim, eta=eta)
        step_args = dict(clip_denoised=clip_denoised, use_ddim=use_ddim)
        rows = None if deterministic else batch_rows
        before = launch_counts()
        with torch.inference_mode():
            if graph and x_T.is_cuda:
                x, snaps, run = self._graph_steps(denoise_fn, x_T, label, tables, deterministic,
                                                  generator, step_args, snapshot_rows, rows)
            else:
                x, snaps = self._eager_steps(denoise_fn, x_T, label, tables, deterministic,
                                             generator, step_args, snapshot_rows, rows)
                run = {"eager_steps": self.sample_timesteps, "captures": 0, "replays": 0,
                       "launches": _delta(launch_counts(), before), "captured_launches": {},
                       "replayed_launches": {}}
        if stats is not None:
            for key, value in run.items():
                if isinstance(value, dict):
                    total = stats.setdefault(key, {})
                    for name, n in value.items():
                        total[name] = total.get(name, 0) + n
                else:
                    stats[key] = stats.get(key, 0) + value
        return x, snaps

    def _eager_steps(self, denoise_fn, x_T, label, tables, deterministic, generator, step_args,
                     snapshot_rows, batch_rows=None):
        """The plain loop: one step after another from the table rows."""
        tables = {k: torch.as_tensor(v, device=x_T.device) for k, v in tables.items()}
        x, snaps = x_T, []
        for i in range(self.sample_timesteps):
            row = {k: v[i] for k, v in tables.items()}
            noise = None if deterministic else draw_rows(
                x.shape, generator, x.device, x.dtype, batch_rows)
            x, pred = self._p_sample_step(denoise_fn, x, row, label, noise, **step_args)
            if i in snapshot_rows:
                snaps.append(pred)
        return x, snaps

    def _graph_steps(self, denoise_fn, x_T, label, tables, deterministic, generator, step_args,
                     snapshot_rows, batch_rows=None):
        """Step 0 eagerly, then the step captured once as a CUDA graph and
        replayed for the other T-1 steps; the graph is freed on return.

        Step 0 runs on the stream the capture then uses: it builds and loads
        the kernels, lets cuBLAS and cuDNN (its autotuner too, where on) pick
        their algorithms and allocates their workspaces, none of which may
        happen inside a capture. Each replay's noise is drawn from
        ``generator`` into the static buffer before it, outside the graph, so
        the draws are the eager loop's. A capture or replay error raises;
        nothing falls back to the eager loop."""
        step = StaticStep(self, denoise_fn, x_T, label, tables, deterministic, step_args,
                          batch_rows)
        T = self.sample_timesteps
        side = torch.cuda.Stream(device=x_T.device)
        side.wait_stream(torch.cuda.current_stream(x_T.device))
        c0 = launch_counts()
        with torch.cuda.stream(side):
            step.draw(generator)
            pred = step()
        torch.cuda.current_stream(x_T.device).wait_stream(side)
        c1 = launch_counts()
        snaps = [pred] if 0 in snapshot_rows else []
        captured = {}
        if T > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                pred = step()
            captured = _delta(launch_counts(), c1)
            for i in range(1, T):
                step.draw(generator)
                graph.replay()
                if i in snapshot_rows:
                    snaps.append(pred.clone())
            del graph
        eager = _delta(c1, c0)
        replayed = {k: n * (T - 1) for k, n in captured.items()}
        run = {"eager_steps": 1, "captures": int(T > 1), "replays": T - 1,
               "launches": {k: eager[k] + replayed.get(k, 0) for k in eager},
               "captured_launches": captured, "replayed_launches": replayed}
        return step.x, snaps, run


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def draw_rows(shape, generator, device, dtype, batch_rows: Optional[Tuple[int, int]] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N(0, I) noise of ``shape`` from ``generator`` (into ``out`` where
    given). With ``batch_rows`` (start, total) the draw is for the whole
    batch of ``total`` rows, and rows ``start`` to ``start + shape[0]`` are
    kept, zeros past ``total``: the noise a rank's slice of a split batch
    receives when one process draws the whole batch."""
    if batch_rows is None:
        if out is not None:
            return torch.randn(shape, generator=generator, out=out)
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    start, total = batch_rows
    whole = torch.randn((total,) + tuple(shape[1:]), generator=generator, device=device,
                        dtype=dtype)
    rows = whole[start:start + shape[0]]
    if out is None:
        out = torch.zeros(shape, device=device, dtype=dtype)
    else:
        out.zero_()
    out[:rows.shape[0]].copy_(rows)
    return out


class StaticStep:
    """One reverse step over buffers whose addresses stay fixed, the form a
    CUDA graph captures: a call reads ``x``, the table row at ``index``, the
    labels and ``noise``, writes x_s into ``x`` in place, advances ``index``
    on the device and returns x̂_0. Each buffer is the caller's value copied
    once; :meth:`draw` fills ``noise`` from the caller's generator as the
    eager loop draws it. Called eagerly it computes what the eager loop's
    step computes, operation for operation."""

    def __init__(self, diffusion: GaussianDiffusion, denoise_fn, x_T: torch.Tensor, label,
                 tables: Dict[str, np.ndarray], deterministic: bool, step_args: dict,
                 batch_rows: Optional[Tuple[int, int]] = None):
        self.diffusion, self.denoise_fn, self.step_args = diffusion, denoise_fn, step_args
        self.batch_rows = batch_rows
        self.keys = list(tables)
        self.table = torch.as_tensor(np.stack([tables[k] for k in self.keys], axis=1),
                                     device=x_T.device)
        self.index = torch.zeros(1, dtype=torch.long, device=x_T.device)
        self.x = x_T.clone()
        self.label = None if label is None else label.clone()
        self.noise = None if deterministic else torch.empty_like(self.x)

    def draw(self, generator: Optional[torch.Generator]):
        if self.noise is not None:
            draw_rows(self.noise.shape, generator, self.noise.device, self.noise.dtype,
                      self.batch_rows, out=self.noise)

    def __call__(self) -> torch.Tensor:
        row = dict(zip(self.keys, self.table.index_select(0, self.index)[0].unbind()))
        x_s, pred = self.diffusion._p_sample_step(self.denoise_fn, self.x, row, self.label,
                                                  self.noise, **self.step_args)
        self.x.copy_(x_s)
        self.index.add_(1)
        return pred
