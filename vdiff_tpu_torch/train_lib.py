"""Training runtime (counterpart of ``vdiff_tpu/train_lib.py``): optimizer,
EMA, the train step, checkpoints and the epoch loop.

* :class:`Optimizer` is optax's ``chain(clip_by_global_norm, adamw)`` with the
  JAX package's linear warmup, written out: torch's own clipping adds an eps
  and a ``LambdaLR`` counts the warmup from another step.
* :func:`make_train_step` returns the step: loss, backward (averaged over
  ``num_accum`` micro-batches), clip, AdamW, EMA. Its random draws — t, noise,
  the CFG keep mask and the dropout bits — come from one ``torch.Generator``
  per micro-batch seeded from (seed, step, micro-batch), so, as in the JAX
  package, a resumed run is determined by (seed, step) alone and checkpoints
  carry no generator state.
* :class:`CheckpointManager` writes ``ckpt_{epoch}.pt`` / ``ckpt_last.pt`` with
  ``torch.save`` and an atomic rename, in the reference layout the port's
  ``generate`` reads (``{"model": sd, "ema": {"shadow": sd}, ...}``).
* :class:`Trainer` is the epoch loop. The in-training FID ``Evaluator`` is the
  metrics slice's (ROADMAP A9).
"""

from __future__ import annotations

import copy
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .factory import load_weights
from .utils.misc import RunningStatistics, save_image


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: scale by max_norm/‖g‖ only when
    ‖g‖ ≥ max_norm, with no eps (``clip_grad_norm_`` adds 1e-6). Returns ‖g‖.
    Stays on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class Optimizer:
    """clip_by_global_norm(grad_norm) → AdamW with lr·min((count+1)/warmup, 1).

    The warmup factor is evaluated at the count of updates made before this
    one, as optax's schedule is: the first update uses 1/warmup. AdamW is
    ``torch.optim.AdamW``, which matches optax ``adamw`` with these settings:
    decay −lr·wd·p on the old p, eps outside the square root, bias correction
    at count+1."""

    def __init__(self, params, lr: float, beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0, warmup: int = 0, grad_norm: float = 1.0):
        self.params = list(params)
        self.lr, self.warmup, self.grad_norm = lr, warmup, grad_norm
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0

    def learning_rate(self) -> float:
        if self.warmup and self.warmup > 0:
            return self.lr * min((self.count + 1.0) / self.warmup, 1.0)
        return self.lr

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        """Clip the params' ``.grad`` and apply one AdamW update."""
        if self.grad_norm and self.grad_norm > 0:
            clip_by_global_norm_([p.grad for p in self.params], self.grad_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.learning_rate()
        self.adamw.step()
        self.count += 1

    def state_dict(self):
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


@torch.no_grad()
def ema_update_(ema_params, params, num_updates: int, decay: float) -> None:
    """shadow += (1 − d)(p − shadow) with d = min(decay, (1+n)/(10+n)), n the
    step count after this update. In place, on the shadow's own storage: torch
    tensors are mutable, and JAX's functional update would cost a copy of the
    model per step."""
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    torch._foreach_add_(ema_params, torch._foreach_sub(params, ema_params), alpha=1.0 - d)


def step_generator(seed: int, step: int, micro: int, device) -> torch.Generator:
    """The generator of one micro-batch's draws, a function of (seed, step,
    micro-batch) only."""
    state = np.random.SeedSequence([seed, step, micro]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_train_step(model, diffusion, optimizer: Optimizer, timesteps: int, num_accum: int = 1,
                    use_cfg: bool = False, ema_decay: float = 0.9999, ema_model=None):
    """The train step ``(x, y, seed, step, draws=None) -> loss`` (a device
    scalar, not synced).

    Per micro-batch: t ~ U(0,1), or (randint(T)+1)/T for discrete training;
    noise ~ N(0, I); the CFG keep mask U(0,1) > p_uncond; then the dropout
    bits inside the forward, all from :func:`step_generator`. ``draws`` (a list
    of ``{"t", "noise", "keep"}`` per micro-batch) replaces the first three, for
    holding the step against another implementation on the same inputs. The
    loss is the per-sample loss meaned; micro-grads are averaged; then clip →
    AdamW → EMA (of the step count after the update)."""
    ema_params = list(ema_model.parameters()) if ema_model is not None else None
    params = list(model.parameters())

    def draw(x, y, gen):
        B, dev = x.shape[0], x.device
        if timesteps > 0:
            t = (torch.randint(0, timesteps, (B,), generator=gen, device=dev) + 1.0) / timesteps
        else:
            t = torch.rand(B, generator=gen, device=dev)
        noise = torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
        keep = None
        if use_cfg and y is not None and diffusion.p_uncond:
            keep = torch.rand(B, generator=gen, device=dev) > diffusion.p_uncond
        return {"t": t, "noise": noise, "keep": keep}

    def micro_loss(x, y, gen, d):
        def denoise_fn(x_t, t_, y_):
            return model(x_t, t_, y_, train=True, generator=gen)

        y = y if use_cfg else None
        return diffusion.train_loss(denoise_fn, x, d["t"], y, d["noise"],
                                    keep=d["keep"] if y is not None else None).mean()

    def train_step(x, y, seed: int, step: int, draws=None):
        optimizer.zero_grad()
        mb = x.shape[0] // num_accum
        loss = 0.0
        for i in range(num_accum):
            xi = x[i * mb:(i + 1) * mb]
            yi = None if y is None else y[i * mb:(i + 1) * mb]
            gen = step_generator(seed, step, i, x.device)
            d = draws[i] if draws is not None else draw(xi, yi if use_cfg else None, gen)
            li = micro_loss(xi, yi, gen, d)
            (li / num_accum if num_accum > 1 else li).backward()
            loss = loss + li.detach() / num_accum
        optimizer.step()
        if ema_params is not None:
            ema_update_(ema_params, params, step + 1, ema_decay)
        return loss

    return train_step


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tag(name: str) -> Optional[str]:
    """The tag of a checkpoint file name (``ckpt_12.pt`` → "12"), or None for
    anything else, such as an interrupted save's temp file."""
    if not (name.startswith("ckpt_") and name.endswith(".pt")):
        return None
    tag = name[len("ckpt_"):-len(".pt")]
    return tag if tag.isdigit() or tag in ("last", "latest") else None


class CheckpointManager:
    """One ``torch.save`` file per checkpoint: ``ckpt_{epoch}.pt``, the final
    epoch ``ckpt_last.pt``; over ``max_ckpts_kept`` (−1: no cap) the oldest
    is deleted."""

    def __init__(self, ckpt_dir: str, max_ckpts_kept: int = -1):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_ckpts_kept = max_ckpts_kept

    def _path(self, tag) -> str:
        return os.path.join(self.ckpt_dir, f"ckpt_{tag}.pt")

    def _checkpoints(self):
        if not os.path.isdir(self.ckpt_dir):
            return []
        return [d for d in os.listdir(self.ckpt_dir) if _ckpt_tag(d) is not None]

    def save(self, payload: dict, epoch: int, epochs: int) -> str:
        """Write ``payload`` (tensors on any device) atomically; returns the path."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self._path("last" if epoch == epochs else epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._retain()
        return path

    def _retain(self):
        if self.max_ckpts_kept == -1:
            return
        ckpts = [os.path.join(self.ckpt_dir, d) for d in self._checkpoints()]
        while len(ckpts) > self.max_ckpts_kept:
            oldest = min(ckpts, key=os.path.getctime)
            os.remove(oldest)
            ckpts.remove(oldest)

    def latest_path(self) -> Optional[str]:
        """ckpt_last/ckpt_latest, else the highest epoch; None when empty."""
        cands = self._checkpoints()
        if not cands:
            return None

        def key(d):
            tag = _ckpt_tag(d)
            return (1, 0) if tag in ("last", "latest") else (0, int(tag))

        return os.path.join(self.ckpt_dir, max(cands, key=key))

    def restore(self, model, optimizer: Optimizer, ema_model=None, path: Optional[str] = None):
        """Load a checkpoint into the given modules; returns (epoch, step)."""
        path = path or self.latest_path()
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(path or self.ckpt_dir)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        load_weights(model, ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        if ema_model is not None and "ema" in ckpt:
            load_weights(ema_model, ckpt["ema"]["shadow"])
        return int(ckpt["epoch"]), int(ckpt["step"])


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------


class Trainer:
    """Epoch loop: one train step per batch, a progress line every 16 steps
    (the only host reads of the loss), a sample grid every ``image_intv``
    epochs drawn under the EMA weights, a checkpoint every ``ckpt_intv``."""

    def __init__(self, model, diffusion, timesteps: int, epochs: int, trainloader,
                 optimizer_config: Optional[dict] = None, use_cfg: bool = False,
                 use_ema: bool = False, grad_norm: float = 1.0, num_accum: int = 1, shape=None,
                 ckpt_intv: int = 512, max_ckpts_kept: int = -1, image_intv: int = 64,
                 num_save_images: int = 64, ema_decay: float = 0.9999, seed: int = 1234,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.diffusion = diffusion
        self.epochs = epochs
        self.start_epoch = 0
        self.trainloader = trainloader
        self.use_cfg = use_cfg
        self.use_ema = use_ema
        self.shape = shape  # (H, W, C)
        self.ckpt_intv = ckpt_intv
        self.max_ckpts_kept = max_ckpts_kept
        self.image_intv = image_intv
        self.num_save_images = num_save_images
        self.seed = seed

        opt_cfg = dict(lr=2e-4, beta1=0.9, beta2=0.999, weight_decay=0.0, warmup=0)
        opt_cfg.update(optimizer_config or {})
        self.optimizer = Optimizer(self.model.parameters(), grad_norm=grad_norm, **opt_cfg)
        self.ema_model = None
        if use_ema:
            self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        self._train_step = make_train_step(self.model, diffusion, self.optimizer, timesteps,
                                           num_accum=num_accum, use_cfg=use_cfg,
                                           ema_decay=ema_decay, ema_model=self.ema_model)
        self.stats = RunningStatistics(loss=None)
        self.ckpt_manager: Optional[CheckpointManager] = None
        self.host_step = 0
        self._pending_losses = []
        # throughput over the steps after the run's first (the first pays for
        # cuDNN's autotuning and the kernels' build)
        self.timing = {"images": 0, "seconds": 0.0}
        # the sampler's stats summed over the sample grids (diffusion.p_sample)
        self.sampler_stats = {}

    @property
    def num_classes(self):
        return self.model.num_classes

    @property
    def multitags(self):
        return self.model.multitags

    def _dummy_label(self, b):
        """The null label of a conditional model: zeros (b,), or (b, K) tags."""
        if not self.num_classes:
            return None
        return np.zeros((b, self.num_classes) if self.multitags else (b,), np.float32)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a) -> torch.Tensor:
        a = torch.as_tensor(a)
        if self.device.type == "cuda" and a.device.type == "cpu":
            # a copy from pageable memory first waits for the stream's queued
            # work, so the host could not run ahead of the card; from pinned
            # memory it is asynchronous
            a = a.pin_memory()
        return a.to(self.device, non_blocking=True)

    def step(self, x, y):
        """One batch (numpy or tensors); the loss stays on the device until
        the stats are read."""
        x = self._to_device(x)
        if y is not None:
            y = self._to_device(y)
        loss = self._train_step(x, y, self.seed, self.host_step)
        self.host_step += 1
        self._pending_losses.append((x.shape[0], loss))
        return loss

    def _flush_stats(self):
        pending, self._pending_losses = self._pending_losses, []
        for B, loss in pending:
            self.stats.update(B, loss=float(loss) * B)

    @property
    def current_stats(self):
        self._flush_stats()
        return {k: round(v, 6) for k, v in self.stats.extract().items()}

    def sampling_model(self):
        return self.ema_model if self.ema_model is not None else self.model

    def sample_fn(self, label=None, batch_size=None, use_ddim=False, seed=0) -> np.ndarray:
        """A batch of samples under the EMA weights, x_T and the sampler's
        noise from a generator seeded with ``seed``; a conditional model
        without ``label`` gets the null label."""
        B = batch_size or self.num_save_images
        H, W, C = self.shape
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x_T = torch.randn((B, H, W, C), generator=gen, device=self.device)
        label = self._dummy_label(B) if label is None else label
        y = None if label is None else torch.as_tensor(label, device=self.device)
        with torch.inference_mode():
            x = self.diffusion.p_sample(self.sampling_model(), x_T, label=y, use_ddim=use_ddim,
                                        generator=gen, stats=self.sampler_stats)
        return x.float().cpu().numpy()

    def sample_labels(self):
        """A balanced class grid: labels 1..K, each repeated ~n/K times; for a
        multi-tag model, n tag rows of the training set drawn with
        ``RandomState(seed)`` (JAX draws them with its label key)."""
        n, K = self.num_save_images, self.num_classes
        if self.multitags:
            targets = np.asarray(self.trainloader.dataset.targets, np.float32)
            return targets[np.random.RandomState(self.seed).randint(len(targets), size=(n,))]
        labels = np.arange(K, dtype=np.float32) + 1
        repeats = np.asarray([n // K + int(i < n % K) for i in range(K)])
        return np.repeat(labels, repeats)

    def train(self, ckpt_dir=None, image_dir=None, use_ddim=False,
              logger: Callable[[str], None] = print) -> dict:
        """Run the remaining epochs; returns a summary (steps, last epoch's
        loss, images/s over the steps after the first, the sample grids'
        sampler stats)."""
        if ckpt_dir and self.ckpt_manager is None:
            self.ckpt_manager = CheckpointManager(ckpt_dir, self.max_ckpts_kept)
        nrow, labels = 8, None
        if self.num_save_images:
            if self.num_classes:
                labels = self.sample_labels()
                nrow = math.ceil(self.num_save_images / self.num_classes)
            else:
                nrow = math.floor(math.sqrt(self.num_save_images))

        first_step = self.host_step
        stats = {}
        for e in range(self.start_epoch, self.epochs):
            self.stats.reset()
            self.trainloader.set_epoch(e)
            n = len(self.trainloader)
            t_start = time.perf_counter()
            for i, (x, y) in enumerate(self.trainloader):
                # labels dropped when CFG is off
                self.step(x, y if self.use_cfg else None)
                if self.host_step == first_step + 1:  # the run's first step: start the clock
                    self._sync()
                    t_start = time.perf_counter()
                else:
                    self.timing["images"] += x.shape[0]
                if i % 16 == 15 or i + 1 == n:
                    # reading the stats waits for the pending steps
                    stats = self.current_stats
                    logger(f"{e + 1}/{self.epochs} epochs, {i + 1}/{n} steps: {stats}")
            self._sync()
            self.timing["seconds"] += time.perf_counter() - t_start

            last = (e + 1) == self.epochs
            if (last or not (e + 1) % self.image_intv) and self.num_save_images and image_dir:
                x = self.sample_fn(label=labels, use_ddim=use_ddim, seed=self.seed * 7919 + e)
                save_image(x, os.path.join(image_dir, f"{e + 1}.png"), nrow=nrow)
            if (last or not (e + 1) % self.ckpt_intv) and self.max_ckpts_kept and self.ckpt_manager:
                self.save_checkpoint(epoch=e + 1, extra=dict(stats))
        t = self.timing
        return {"steps": self.host_step - first_step, "loss": stats.get("loss"),
                "img_per_s": t["images"] / t["seconds"] if t["images"] else None,
                "sampler": self.sampler_stats}

    def save_checkpoint(self, epoch: int, extra=None) -> str:
        assert self.ckpt_manager is not None
        cpu = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}
        payload = {"model": cpu(self.model), "optimizer": self.optimizer.state_dict(),
                   "step": self.host_step, "epoch": epoch, "extra": extra or {}}
        if self.ema_model is not None:
            payload["ema"] = {"shadow": cpu(self.ema_model)}
        return self.ckpt_manager.save(payload, epoch, self.epochs)

    def load_checkpoint(self, ckpt_path=None, ckpt_dir=None):
        """Restore model, EMA, optimizer, epoch and step; the draws of the
        following steps then equal those of an uninterrupted run."""
        if self.ckpt_manager is None:
            assert ckpt_dir is not None
            self.ckpt_manager = CheckpointManager(ckpt_dir, self.max_ckpts_kept)
        self.start_epoch, self.host_step = self.ckpt_manager.restore(
            self.model, self.optimizer, self.ema_model, ckpt_path)
