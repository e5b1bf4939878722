"""A dry run of the multi-rank paths (counterpart of
``__graft_entry__.py::dryrun_multichip``: its DP, FSDP, HSDP, TP and SP
phases).

    python -m vdiff_tpu_torch.parallel.dryrun 2 [--device cpu]

:func:`dryrun_multichip` spawns ``n`` ranks, by default NCCL on ``n`` GPUs
(it stops, naming the count it found, where the machine has fewer) and with
``--device cpu`` gloo on the CPU, and on each runs, at small
widths (hid 32, ch_mult (1, 2), one res block, attention at the lower level,
16x16, CFG with 10 classes, dropout 0.1, two micro-batches of 2 a rank):

* one DDP train step (``Trainer(distributed=True)``) and one collective DDIM
  sampling call, whose samples must be equal on every rank;
* one FSDP step from the same weights and draws, whose loss must be the DDP
  step's within 1e-4;
* for ``n >= 4`` (even), one HSDP step on the 2-D (data, fsdp=2) mesh, held
  to the same bound;
* the serving modes on the DDP step's weights, batch replicated (B=2): one
  forward with the weights TP-sharded (:mod:`.tp`) and one height-sharded
  forward (:mod:`.spatial`; where ``n`` divides the 8 rows of the lower
  level), each finite and within 1e-4 of the plain forward on every rank.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

RES = 16
LOSS_RTOL = 1e-4
FWD_ATOL = 1e-4  # the TP and SP forwards against the plain one, as JAX's dry run


def _build(seed: int = 0):
    from ..diffusion import GaussianDiffusion
    from ..models.unet import UNet
    from ..ops.numerics import get_logsnr_schedule

    model = UNet(in_channels=3, hid_channels=32, out_channels=3, ch_multipliers=(1, 2),
                 num_res_blocks=1, apply_attn=(False, True), drop_rate=0.1, num_heads=1,
                 num_classes=10, generator=torch.Generator().manual_seed(seed))
    diffusion = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), sample_timesteps=4,
                                  model_out_type="v", model_var_type="fixed_medium",
                                  reweight_type="snr_trunc", loss_type="mse", intp_frac=0.3,
                                  w_guide=0.1, p_uncond=0.1)
    return model, diffusion


def _trainer(device, **parallel):
    from ..train_lib import Trainer

    model, diffusion = _build()
    return Trainer(model, diffusion, timesteps=0, epochs=1, trainloader=None,
                   optimizer_config=dict(lr=2e-4, warmup=10), use_cfg=True, use_ema=True,
                   grad_norm=1.0, num_accum=2, shape=(RES, RES, 3), seed=0, device=device,
                   **parallel)


def _worker(index: int, n: int, init_file: str, device_type: str) -> None:
    from .mesh import init_distributed, shard_batch

    os.environ.update(RANK=str(index), WORLD_SIZE=str(n), LOCAL_RANK=str(index))
    torch.set_num_threads(1)
    device = init_distributed(device_type, init_method=f"file://{init_file}")
    try:
        rng = np.random.RandomState(0)  # the same global batch on every rank
        B = 4 * n
        x = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
        y = rng.randint(1, 11, (B,)).astype(np.int64)
        xl, yl = shard_batch(x, y)

        dp = _trainer(device, distributed=True)
        loss = float(dp.step(xl, yl))
        if not np.isfinite(loss) or dp.host_step != 1:
            raise RuntimeError(f"DDP step: loss {loss}, step {dp.host_step}")
        samples = dp.sample_fn(label=y.astype(np.float32), batch_size=B, use_ddim=True, seed=1)
        if samples.shape != (B, RES, RES, 3) or not np.isfinite(samples).all():
            raise RuntimeError(f"sampling gave {samples.shape}")
        everyone = [None] * n
        torch.distributed.all_gather_object(everyone, samples)
        if any(not np.array_equal(s, samples) for s in everyone):
            raise RuntimeError("the ranks sampled different batches")

        modes = {"fsdp": dict(fsdp=True)}
        if n >= 4 and n % 2 == 0:
            modes["hsdp"] = dict(fsdp_size=2)
        for name, kw in modes.items():
            other = float(_trainer(device, **kw).step(xl, yl))
            if abs(other - loss) > LOSS_RTOL * max(1.0, abs(loss)):
                raise RuntimeError(f"{name} loss {other} != the DDP step's {loss}")
        served = _serving_modes(dp.module, device)
        if index == 0:
            print(f"dryrun_multichip({n}) on {device_type}: DDP loss {loss}, "
                  f"{', '.join(modes)} within {LOSS_RTOL}; {B} samples equal on every rank; "
                  f"{served}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def _serving_modes(trained, device) -> str:
    """The TP and SP forwards of ``trained``'s weights against the plain
    forward (TP+SP is held in the tests); returns the line's clause."""
    from .fsdp import state_bytes_per_device
    from .spatial import SpatialShardedUNet, rows_per_rank
    from .tp import tp_shard_model_

    def fresh():
        model = _build()[0].to(device).eval()
        model.load_state_dict(trained.state_dict())
        return model

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, RES, RES, 3, generator=gen).to(device)
    t, y = torch.full((2,), 0.5, device=device), torch.ones(2, device=device)
    with torch.inference_mode():
        plain = fresh()
        ref = plain(x, t, y)
        tp = tp_shard_model_(fresh())
        outs = {"TP": tp(x, t, y)}
        try:
            rows_per_rank(RES, len(plain.downsamples), torch.distributed.get_world_size())
            outs["SP"] = SpatialShardedUNet(fresh())(x, t, y)
        except ValueError as e:
            skipped = f"SP not run ({e})"
    for name, out in outs.items():
        err = (out - ref).abs().max().item()
        if not bool(torch.isfinite(out).all()) or err > FWD_ATOL:
            raise RuntimeError(f"{name} forward: max err {err} against the plain forward")
    return (f"{' and '.join(outs)} forward{'s' * (len(outs) > 1)} within {FWD_ATOL} of the plain forward, TP "
            f"parameter bytes a rank {state_bytes_per_device(tp)} of "
            f"{state_bytes_per_device(plain)}" + ("" if "SP" in outs else f"; {skipped}"))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the dry run on ``n_devices`` ranks (see the module docstring), one
    a GPU for ``device`` "cuda" (NCCL), on the CPU for "cpu" (gloo); raises
    if any rank fails."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise SystemExit(f"dryrun_multichip({n_devices}) on cuda needs {n_devices} GPUs, "
                         f"found {torch.cuda.device_count()}; --device cpu runs it on gloo")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_worker, args=(n_devices, os.path.join(tmp, "rendezvous"),
                                          device_type),
                           nprocs=n_devices, start_method="spawn")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="the DP, FSDP, HSDP, TP and SP dry run")
    parser.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
