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
* :class:`Trainer` is the epoch loop; every ``eval_intv`` epochs it hands an
  :class:`Evaluator` (in-training FID) a sampler of the EMA model.

Under torchrun (``Trainer(distributed=True)``, a process group joined) each
rank trains on its shard of every batch: the model is wrapped in DDP, or with
``fsdp``/``fsdp_size`` sharded by FSDP2 (``parallel/fsdp.py``). A step's draws
are those of the global batch, so it does not depend on the world size;
sampling, evaluation and checkpoints are collective, every rank calling them
and holding the same result, as the JAX package's mesh gives.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .factory import load_weights
from .parallel.mesh import (all_gather_rows, all_reduce_mean_, create_mesh, leader_value, rank,
                            sync_global_devices, world_size)
from .utils.misc import RunningStatistics, save_image


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: scale by max_norm/‖g‖ only when
    ‖g‖ ≥ max_norm, with no eps (``clip_grad_norm_`` adds 1e-6). Returns ‖g‖.
    Stays on the device: no host sync. FSDP's gradients are DTensor shards:
    each rank takes the norm of its shards and the squares are summed over
    the ranks that share them, so every rank scales by the global norm."""
    from .parallel.fsdp import local, shard_group

    group = shard_group(grads)
    grads = [local(g) for g in grads]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if group is not None:
        norm = norm.square()
        dist.all_reduce(norm, group=group)
        norm = norm.sqrt()
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
        """The single-card layout, whole tensors on the CPU: under FSDP the
        moments are gathered, so every rank must call it."""
        from .parallel.fsdp import full_optimizer_state

        return {"adamw": full_optimizer_state(self.adamw), "count": self.count}

    def load_state_dict(self, state):
        """Load :meth:`state_dict`'s layout; under FSDP each rank keeps the
        shards of its parameters."""
        from .parallel.fsdp import load_full_optimizer_state_

        load_full_optimizer_state_(self.adamw, state["adamw"])
        self.count = int(state["count"])


@torch.no_grad()
def ema_update_(ema_params, params, num_updates: int, decay: float) -> None:
    """shadow += (1 − d)(p − shadow) with d = min(decay, (1+n)/(10+n)), n the
    step count after this update. In place, on the shadow's own storage: torch
    tensors are mutable, and JAX's functional update would cost a copy of the
    model per step. Sharded (FSDP) tensors update shard by shard."""
    from .parallel.fsdp import local

    ema_params, params = [local(e) for e in ema_params], [local(p) for p in params]
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    torch._foreach_add_(ema_params, torch._foreach_sub(params, ema_params), alpha=1.0 - d)


def step_generator(seed: int, step: int, micro: int, device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The generator of one micro-batch's draws, a function of (seed, step,
    micro-batch) only; with ``rank``, that rank's dropout generator of a
    multi-rank step."""
    entropy = [seed, step, micro] + ([] if rank is None else [rank])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _grad_sync(model, enabled: bool):
    """A context in which the backward reduces the gradients over the ranks
    (``enabled``) or keeps them local to accumulate: DDP's ``no_sync``,
    FSDP2's ``set_requires_gradient_sync``; nothing for a plain module."""
    if hasattr(model, "no_sync"):
        return contextlib.nullcontext() if enabled else model.no_sync()
    if hasattr(model, "set_requires_gradient_sync"):
        model.set_requires_gradient_sync(enabled)
    return contextlib.nullcontext()


def make_train_step(model, diffusion, optimizer: Optimizer, timesteps: int, num_accum: int = 1,
                    use_cfg: bool = False, ema_decay: float = 0.9999, ema_model=None,
                    rank: int = 0, world: int = 1):
    """The train step ``(x, y, seed, step, draws=None) -> loss`` (a device
    scalar, not synced).

    Per micro-batch: t ~ U(0,1), or (randint(T)+1)/T for discrete training;
    noise ~ N(0, I); the CFG keep mask U(0,1) > p_uncond; then the dropout
    bits inside the forward, all from :func:`step_generator`. ``draws`` (a list
    of ``{"t", "noise", "keep"}`` per micro-batch) replaces the first three, for
    holding the step against another implementation on the same inputs. The
    loss is the per-sample loss meaned; micro-grads are averaged; then clip →
    AdamW → EMA (of the step count after the update).

    On ``world`` ranks (``model`` a DDP or FSDP module) ``x`` is this rank's
    shard, and micro-batch i of the global batch is every rank's i-th
    micro-batch in rank order. Its t, noise and keep mask (and ``draws``) are
    drawn for that whole global micro-batch and this rank keeps its rows, as
    one JAX key draws the whole sharded batch; so the step is the one-rank
    step on the global batch. The dropout bits come from a generator of (seed,
    step, micro-batch, rank), so that no two ranks drop alike; with dropout
    on, a step on several ranks therefore differs from one on one rank. The
    gradients are reduced on the last micro-batch only, and the returned loss
    is the global mean on every rank."""
    ema_params = list(ema_model.parameters()) if ema_model is not None else None
    params = list(model.parameters())

    def rows(d, mb):
        return {k: None if v is None else v[rank * mb:(rank + 1) * mb] for k, v in d.items()}

    def draw(x, y, gen):
        B, dev = x.shape[0] * world, x.device
        if timesteps > 0:
            t = (torch.randint(0, timesteps, (B,), generator=gen, device=dev) + 1.0) / timesteps
        else:
            t = torch.rand(B, generator=gen, device=dev)
        noise = torch.randn((B,) + tuple(x.shape[1:]), generator=gen, device=dev, dtype=x.dtype)
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
            d = rows(d, mb)
            if world > 1:
                gen = step_generator(seed, step, i, x.device, rank=rank)
            with _grad_sync(model, i == num_accum - 1):
                li = micro_loss(xi, yi, gen, d)
                (li / num_accum if num_accum > 1 else li).backward()
            loss = loss + li.detach() / num_accum
        if world > 1:
            loss = all_reduce_mean_(loss)
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

    def path_for(self, epoch: int, epochs: int) -> str:
        """The file the checkpoint of ``epoch`` (of ``epochs``) is written to."""
        return self._path("last" if epoch == epochs else epoch)

    def save(self, payload: dict, epoch: int, epochs: int) -> str:
        """Write ``payload`` (tensors on any device) atomically; returns the path."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self.path_for(epoch, epochs)
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
        """Load a checkpoint into the given modules; returns (epoch, step).
        Sharded (FSDP) modules take their shards of the whole tensors."""
        path = path or self.latest_path()
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(path or self.ckpt_dir)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        _load_module(model, ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        if ema_model is not None and "ema" in ckpt:
            _load_module(ema_model, ckpt["ema"]["shadow"])
        return int(ckpt["epoch"]), int(ckpt["step"])


def _load_module(module, state_dict: dict) -> None:
    """``load_weights`` for a plain module; each rank's shards for a sharded one."""
    from torch.distributed.tensor import DTensor

    from .parallel.fsdp import load_full_state_dict_

    if any(isinstance(p, DTensor) for p in module.parameters()):
        load_full_state_dict_(module, state_dict)
    else:
        load_weights(module, state_dict)


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------


class Trainer:
    """Epoch loop: one train step per batch, a progress line every 16 steps
    (the only host reads of the loss), a sample grid every ``image_intv``
    epochs drawn under the EMA weights, a checkpoint every ``ckpt_intv``.

    ``distributed`` (a process group joined, one rank per device) wraps the
    model in DDP; ``fsdp``, or ``fsdp_size > 1`` for the hybrid (data, fsdp)
    mesh, shards it, its EMA and the Adam moments with FSDP2 instead. Every
    rank then runs the loop on its own loader's shard of each batch; only
    rank 0 logs and writes images and checkpoints. ``model`` stays the module
    the step calls (the DDP wrapper, or the sharded UNet) and ``module`` the
    UNet itself."""

    def __init__(self, model, diffusion, timesteps: int, epochs: int, trainloader,
                 optimizer_config: Optional[dict] = None, use_cfg: bool = False,
                 use_ema: bool = False, grad_norm: float = 1.0, num_accum: int = 1, shape=None,
                 ckpt_intv: int = 512, max_ckpts_kept: int = -1, image_intv: int = 64,
                 num_save_images: int = 64, ema_decay: float = 0.9999, seed: int = 1234,
                 eval_intv: int = 128, device="cuda", distributed: bool = False,
                 fsdp: bool = False, fsdp_size: int = 0):
        self.device = torch.device(device)
        module = model.to(self.device)
        self.fsdp = bool(fsdp) or fsdp_size > 1
        self.distributed = bool(distributed) or self.fsdp
        self.rank, self.world = (rank(), world_size()) if self.distributed else (0, 1)
        self.is_leader = self.rank == 0
        # the data mesh (the Evaluator's and the sampler's ranks); the hybrid
        # one under fsdp_size, whose minor axis holds the state
        self.mesh = create_mesh(fsdp_size if fsdp_size > 1 else 1) if self.distributed else None
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
        self.eval_intv = eval_intv
        self.seed = seed

        self.ema_model = None
        if use_ema:
            self.ema_model = copy.deepcopy(module).requires_grad_(False)
        # under FSDP the sampler runs a plain UNet that each sampling call
        # fills with the gathered weights; its structure is kept on "meta"
        self._plain = None
        if self.fsdp:
            from .parallel.fsdp import shard_model

            self._plain = copy.deepcopy(module).requires_grad_(False).to("meta")
            shard_model(module, self.mesh)
            if self.ema_model is not None:
                shard_model(self.ema_model, self.mesh)  # the same placement as the params'
            self.model = module
        elif self.distributed:
            from torch.nn.parallel import DistributedDataParallel

            self.model = DistributedDataParallel(
                module, device_ids=[self.device] if self.device.type == "cuda" else None)
        else:
            self.model = module
        self.module = module

        opt_cfg = dict(lr=2e-4, beta1=0.9, beta2=0.999, weight_decay=0.0, warmup=0)
        opt_cfg.update(optimizer_config or {})
        # built after sharding: FSDP2 replaces the parameters with DTensors
        self.optimizer = Optimizer(module.parameters(), grad_norm=grad_norm, **opt_cfg)
        self._train_step = make_train_step(self.model, diffusion, self.optimizer, timesteps,
                                           num_accum=num_accum, use_cfg=use_cfg,
                                           ema_decay=ema_decay, ema_model=self.ema_model,
                                           rank=self.rank, world=self.world)
        self.stats = RunningStatistics(loss=None)
        self.ckpt_manager: Optional[CheckpointManager] = None
        self.host_step = 0
        self._pending_losses = []
        self.epoch_losses = []  # the losses of this epoch's steps read so far
        # throughput over the steps after the run's first (the first pays for
        # cuDNN's autotuning and the kernels' build)
        self.timing = {"images": 0, "seconds": 0.0}
        # the sampler's stats summed over the sample grids (diffusion.p_sample)
        self.sampler_stats = {}

    @property
    def num_classes(self):
        return self.module.num_classes

    @property
    def multitags(self):
        return self.module.multitags

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
            self.epoch_losses.append(float(loss))
            self.stats.update(B, loss=float(loss) * B)

    @property
    def current_stats(self):
        self._flush_stats()
        return {k: round(v, 6) for k, v in self.stats.extract().items()}

    def sampling_model(self):
        """The UNet the sampler runs: the EMA model, else the trained one.
        Under FSDP, a plain UNet holding their weights gathered whole (a
        collective: every rank calls it), so the sampler's step runs with no
        per-block hooks and is captured as one CUDA graph as on one card."""
        src = self.ema_model if self.ema_model is not None else self.module
        if self._plain is None:
            return src
        from .parallel.fsdp import gather_into_

        plain = copy.deepcopy(self._plain).to_empty(device=self.device)
        gather_into_(plain, src)
        return plain

    def sample_fn(self, label=None, batch_size=None, use_ddim=False, seed=0,
                  diffusion=None) -> np.ndarray:
        """A batch of samples under the EMA weights from ``diffusion`` (the
        trainer's by default), x_T and the sampler's noise from a generator
        seeded with ``seed``; a conditional model without ``label`` gets the
        null label.

        Collective on several ranks: each draws the whole batch's x_T (and
        takes the labels of the whole batch), pads a batch the world size
        does not divide, samples its contiguous rows with the whole batch's
        noise (``p_sample(batch_rows=...)``) and the rows are all-gathered, so
        every rank returns the same samples, those one rank would draw."""
        B = batch_size or self.num_save_images
        H, W, C = self.shape
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x_T = torch.randn((B, H, W, C), generator=gen, device=self.device)
        label = self._dummy_label(B) if label is None else label
        y = None if label is None else torch.as_tensor(label, device=self.device)
        model = self.sampling_model()
        rows = None
        if self.world > 1:
            per = -(-B // self.world)
            start = self.rank * per
            x_T = _pad_rows(x_T, per * self.world)[start:start + per]
            y = None if y is None else _pad_rows(y, per * self.world)[start:start + per]
            rows = (start, B)
        with torch.inference_mode():
            x = (diffusion or self.diffusion).p_sample(
                model, x_T, label=y, use_ddim=use_ddim, generator=gen,
                stats=self.sampler_stats, batch_rows=rows)
            if self.world > 1:
                x = all_gather_rows(x)[:B]
        return x.float().cpu().numpy()

    def eval_labels(self, b: int, rng: np.random.RandomState) -> np.ndarray:
        """Random conditional labels for in-training FID, as the generate CLI
        draws them: classes uniform in [1, K], or tag rows of the training
        set for a multi-tag model."""
        if self.multitags:
            targets = np.asarray(self.trainloader.dataset.targets, np.float32)
            return targets[rng.randint(len(targets), size=(b,))]
        return rng.randint(1, self.num_classes + 1, size=(b,)).astype(np.float32)

    def eval_sampler(self, epoch: int, use_ddim: bool = False):
        """``sample_fn(batch_size, diffusion)`` for the :class:`Evaluator` at
        ``epoch``: the k-th call's noise and labels come from seeds of (seed,
        epoch, k), so every batch differs and a rerun draws the same. A
        conditional model samples conditionally (the headline FID's
        protocol) when CFG training is on."""
        draws = iter(range(1 << 30))

        def sample(b, diffusion=None):
            k = next(draws)
            seed = int(np.random.SeedSequence([self.seed, 1 + epoch, k]).generate_state(1)[0])
            y = None
            if self.use_cfg and self.num_classes:
                y = self.eval_labels(b, np.random.RandomState(seed))
            return self.sample_fn(label=y, batch_size=b, use_ddim=use_ddim, seed=seed,
                                  diffusion=diffusion)

        return sample

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
              logger: Callable[[str], None] = print, evaluator=None) -> dict:
        """Run the remaining epochs; returns a summary (steps, last epoch's
        loss, images/s over the steps after the first, the sample grids' and
        evaluations' sampler stats, the last evaluation's results). With an
        ``evaluator``, every ``eval_intv`` epochs end with its ``eval``, the
        results logged with the epoch's stats and kept in the checkpoint.
        On several ranks every rank runs the loop (the sampling, evaluation
        and checkpoint calls are collective) and rank 0 alone logs and writes
        the sample grids."""
        if not self.is_leader:
            logger = _silent
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
        stats, last_eval = {}, {}
        for e in range(self.start_epoch, self.epochs):
            self.stats.reset()
            self.epoch_losses = []
            results = {}  # this epoch's evaluation, kept in its checkpoint
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
                    self.timing["images"] += x.shape[0] * self.world
                if i % 16 == 15 or i + 1 == n:
                    # reading the stats waits for the pending steps
                    stats = self.current_stats
                    logger(f"{e + 1}/{self.epochs} epochs, {i + 1}/{n} steps: {stats}")
            self._sync()
            self.timing["seconds"] += time.perf_counter() - t_start
            if evaluator is not None and not (e + 1) % self.eval_intv:
                results = last_eval = {**stats, **evaluator.eval(self.eval_sampler(e, use_ddim),
                                                                  logger)}
                logger(f"{e + 1}/{self.epochs} epochs: {results}")

            last = (e + 1) == self.epochs
            if (last or not (e + 1) % self.image_intv) and self.num_save_images and image_dir:
                x = self.sample_fn(label=labels, use_ddim=use_ddim, seed=self.seed * 7919 + e)
                if self.is_leader:
                    save_image(x, os.path.join(image_dir, f"{e + 1}.png"), nrow=nrow)
            if (last or not (e + 1) % self.ckpt_intv) and self.max_ckpts_kept and self.ckpt_manager:
                self.save_checkpoint(epoch=e + 1, extra=dict(results or stats))
        t = self.timing
        return {"steps": self.host_step - first_step, "loss": stats.get("loss"),
                "losses": list(self.epoch_losses),
                "img_per_s": t["images"] / t["seconds"] if t["images"] else None,
                "sampler": self.sampler_stats, "eval": last_eval}

    def save_checkpoint(self, epoch: int, extra=None) -> str:
        """Write the single-card layout, whole tensors (gathered under FSDP,
        so every rank calls it); rank 0 writes and the others wait at a
        barrier until the file is there. Returns its path."""
        from .parallel.fsdp import full_state_dict

        assert self.ckpt_manager is not None
        payload = {"model": full_state_dict(self.module), "optimizer": self.optimizer.state_dict(),
                   "step": self.host_step, "epoch": epoch, "extra": extra or {}}
        if self.ema_model is not None:
            payload["ema"] = {"shadow": full_state_dict(self.ema_model)}
        path = self.ckpt_manager.path_for(epoch, self.epochs)
        if self.is_leader:
            path = self.ckpt_manager.save(payload, epoch, self.epochs)
        if self.world > 1:
            sync_global_devices("checkpoint")
        return path

    def load_checkpoint(self, ckpt_path=None, ckpt_dir=None):
        """Restore model, EMA, optimizer, epoch and step; the draws of the
        following steps then equal those of an uninterrupted run. Every rank
        reads the file; under FSDP each keeps its shards."""
        if self.ckpt_manager is None:
            assert ckpt_dir is not None
            self.ckpt_manager = CheckpointManager(ckpt_dir, self.max_ckpts_kept)
        self.start_epoch, self.host_step = self.ckpt_manager.restore(
            self.module, self.optimizer, self.ema_model, ckpt_path)


def _silent(_msg: str) -> None:
    """The logger of the ranks other than 0."""


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows`` (its own shape past dim 0)."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


class Evaluator:
    """In-training FID: ``eval(sample_fn)`` streams ``max_eval_count`` (plus
    one batch) samples of ``sample_fn(eval_batch_size, diffusion)`` through the
    FID Inception's statistics on ``device`` and returns {"fid": ...} against
    the dataset's precomputed statistics (or ``target_stats``). Missing
    statistics or Inception weights skip the evaluation with a logged reason
    instead of stopping the training, as the eval CLI skips a metric.

    With the training's ``mesh`` every rank calls ``eval`` (the sampler is
    collective): each runs its slice of every Inception batch and the
    features are gathered (``metrics/device_apply.py``); the Fréchet distance
    is computed on rank 0 and broadcast."""

    def __init__(self, dataset: str, diffusion=None, eval_batch_size: int = 256,
                 max_eval_count: int = 10000, precomputed_dir: str = "precomputed",
                 feature_fn=None, target_stats=None, device="cuda", mesh=None):
        from .metrics.fid import InceptionStatistics, calc_fd, get_precomputed

        self.diffusion = diffusion
        self.mesh = mesh
        dim = len(target_stats[0]) if target_stats is not None else 2048
        self.istats = InceptionStatistics(feature_fn=feature_fn, activation_dim=dim,
                                          device=device, mesh=mesh)
        self.eval_batch_size = eval_batch_size
        self.max_eval_count = max_eval_count
        self._skip_reason = None
        if target_stats is not None:
            self.target_mean, self.target_var = target_stats
        else:
            try:
                self.target_mean, self.target_var = get_precomputed(
                    dataset, download_dir=precomputed_dir)
            except FileNotFoundError as e:
                self.target_mean = self.target_var = None
                self._skip_reason = str(e)
        self._calc_fd = calc_fd

    def eval(self, sample_fn, logger: Callable[[str], None] = print) -> dict:
        if self._skip_reason is not None:
            logger(f"FID skipped: {self._skip_reason}")
            return {}
        self.istats.reset()
        try:
            for _ in range(0, self.max_eval_count + self.eval_batch_size, self.eval_batch_size):
                self.istats.update(np.asarray(sample_fn(self.eval_batch_size, self.diffusion)))
        except FileNotFoundError as e:  # the Inception weights are absent
            self._skip_reason = str(e)
            logger(f"FID skipped: {self._skip_reason}")
            return {}
        gen_mean, gen_var = self.istats.get_statistics()
        return {"fid": leader_value(
            lambda: self._calc_fd(gen_mean, gen_var, self.target_mean, self.target_var), self.mesh)}
