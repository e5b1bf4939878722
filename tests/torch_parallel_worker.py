"""One rank of the port's multi-rank CPU tests (tests/test_torch_parallel*.py,
tests/test_torch_tp.py).

    python tests/torch_parallel_worker.py RANK WORLD WORKDIR PHASE[,PHASE...]

Joins a gloo group through ``file://WORKDIR/rendezvous`` (no TCP port, so
pytest-xdist workers never race for one), reads the inputs the test wrote to
``WORKDIR/setup.pt`` (the small UNet's weights, the global batch, the global
draws per micro-batch, the CLI files) and runs the phases in order, every
rank together. Each rank writes what it measured to
``WORKDIR/result_RANK.pt`` and prints ``WORKER_OK RANK``; any exception
fails the test through the exit code. Imports torch and the port, never JAX.
"""

import os
import sys


def main():
    rank, world, workdir, phases = sys.argv[1:5]
    rank, world = int(rank), int(world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    from vdiff_tpu_torch.parallel import init_distributed

    init_distributed("cpu", init_method=f"file://{os.path.join(workdir, 'rendezvous')}")
    setup = torch.load(os.path.join(workdir, "setup.pt"), weights_only=False)
    results = {}
    for phase in phases.split(","):
        PHASES[phase](rank, world, workdir, setup, results)
        torch.distributed.barrier()
    torch.save(results, os.path.join(workdir, f"result_{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _model(setup):
    from vdiff_tpu_torch.models.unet import UNet

    model = UNet(**setup["cfg"])
    model.load_state_dict(setup["weights"], strict=True)
    return model


def _diffusion(setup):
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    return GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **setup["diffusion"])


def _trainer(setup, **parallel):
    from vdiff_tpu_torch.train_lib import Trainer

    return Trainer(_model(setup), _diffusion(setup), timesteps=0, epochs=1, trainloader=None,
                   optimizer_config=setup["optimizer"], use_cfg=True, use_ema=True,
                   grad_norm=setup["grad_norm"], num_accum=setup["num_accum"],
                   shape=setup["shape"], ema_decay=setup["ema_decay"], seed=0, device="cpu",
                   **parallel)


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _rank_rows(setup, rank, world):
    """This rank's batch: its micro-batch i is rows [i·mb_g + rank·mb, ...) of
    the global batch, so that every global micro-batch is the global batch's
    i-th slice, as JAX's reshape of the sharded batch makes it."""
    import torch

    x, y, A = setup["x"], setup["y"], setup["num_accum"]
    mb_g = x.shape[0] // A
    mb = mb_g // world
    idx = torch.cat([torch.arange(i * mb_g + rank * mb, i * mb_g + (rank + 1) * mb)
                     for i in range(A)])
    return x[idx], y[idx]


def _step(trainer, x, y, draws):
    """One train step with the explicit global draws; returns the loss, the
    whole pre-clip gradients and the whole params and EMA after it."""
    record = {}
    step = trainer.optimizer.step

    def recording_step():
        record["grads"] = {k: _full(p.grad) for k, p in trainer.module.named_parameters()}
        step()

    trainer.optimizer.step = recording_step
    loss = trainer._train_step(x, y, 0, 0, draws=draws)
    trainer.optimizer.step = step
    return {"loss": float(loss), "grads": record["grads"],
            "params": {k: _full(p) for k, p in trainer.module.named_parameters()},
            "ema": {k: _full(p) for k, p in trainer.ema_model.named_parameters()}}


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_data(rank, world, workdir, setup, results):
    """get_dataloader(distributed=True): the world-divided batch of this
    rank's shard, and its first batch of epoch 1 with flips on; a dataset
    missing on every rank fails each of them."""
    import numpy as np

    from vdiff_tpu_torch.data import DataLoader, get_dataloader

    loader, _ = get_dataloader("synthetic", batch_size=16, split="train", random_seed=3,
                               root=workdir, distributed=True)
    ref = DataLoader(loader.dataset, batch_size=8, seed=3, process_index=rank,
                     process_count=world)
    assert loader.batch_size == 8 and len(loader) == len(ref) == 512 // world // 8
    loader.set_epoch(1)
    ref.set_epoch(1)
    (x, y), (rx, ry) = next(iter(loader)), next(iter(ref))
    assert np.array_equal(x, rx) and np.array_equal(y, ry)
    results["data_indices"] = loader._epoch_indices()
    loader.dataset.random_flip = True  # this rank's flip stream, held against JAX's loader
    results["data_flipped_batch"] = next(iter(loader))
    try:
        get_dataloader("cifar10", batch_size=16, split="train", random_seed=0,
                       root=os.path.join(workdir, "definitely_missing"), distributed=True)
    except FileNotFoundError:
        results["missing_raised"] = True


def phase_sample(rank, world, workdir, setup, results):
    """The collective sample_fn of fresh DDP and FSDP trainers (the EMA is
    the initial weights) on a batch of 9 with labels, ancestral; rank 0 also
    samples with a one-rank trainer."""
    import numpy as np

    y9 = np.arange(9, dtype=np.float32) % 11
    kw = dict(label=y9, batch_size=9, use_ddim=False, seed=5)
    results["sample_ddp"] = _trainer(setup, distributed=True).sample_fn(**kw)
    results["sample_fsdp"] = _trainer(setup, fsdp=True).sample_fn(**kw)
    if rank == 0:
        results["sample_one"] = _trainer(setup).sample_fn(**kw)


def _parallel_step(name, parallel):
    def phase(rank, world, workdir, setup, results):
        trainer = _trainer(setup, **parallel)
        x, y = _rank_rows(setup, rank, world)
        results[name] = _step(trainer, x, y, setup["draws"])
        if name != "ddp":
            from vdiff_tpu_torch.parallel import state_bytes_per_device

            results[name]["state_bytes"] = state_bytes_per_device(
                trainer.module, trainer.optimizer, trainer.ema_model)
        if name == "fsdp":  # its checkpoint, gathered whole, for the one-process restore
            from vdiff_tpu_torch.train_lib import CheckpointManager

            trainer.ckpt_manager = CheckpointManager(os.path.join(workdir, "fsdp_ckpts"))
            results["fsdp_ckpt"] = trainer.save_checkpoint(epoch=1)
            results["fsdp_opt"] = trainer.optimizer.state_dict()
    return phase


def phase_replicated(rank, world, workdir, setup, results):
    """The one-rank step on the global batch (rank 0), and its checkpoint,
    which every rank then restores into a fresh FSDP trainer."""
    from vdiff_tpu_torch.train_lib import CheckpointManager

    ckpt_dir = os.path.join(workdir, "one_ckpts")
    if rank == 0:
        trainer = _trainer(setup)
        results["one"] = _step(trainer, setup["x"], setup["y"], setup["draws"])
        trainer.ckpt_manager = CheckpointManager(ckpt_dir)
        trainer.save_checkpoint(epoch=1)
        results["one_opt"] = trainer.optimizer.state_dict()
    import torch

    torch.distributed.barrier()
    restored = _trainer(setup, fsdp=True)
    restored.load_checkpoint(ckpt_dir=ckpt_dir)
    results["restored"] = {
        "params": {k: _full(p) for k, p in restored.module.named_parameters()},
        "ema": {k: _full(p) for k, p in restored.ema_model.named_parameters()},
        "opt": restored.optimizer.state_dict(),
        "epoch_step": (restored.start_epoch, restored.host_step),
    }


def phase_generate(rank, world, workdir, setup, results):
    """generate --dp on every rank, the float samples captured before the
    PNG writer quantises them."""
    import numpy as np

    from vdiff_tpu_torch import generate

    captured = []
    write = generate.write_pngs
    generate.write_pngs = lambda save_dir, x: (captured.append(np.array(x)), write(save_dir, x))
    try:
        summary = generate.main(setup["generate_args"] + ["--dp", "--save-dir",
                                                          os.path.join(workdir, "gen_dp")])
    finally:
        generate.write_pngs = write
    results["generate"] = np.concatenate(captured) if captured else None
    results["generate_summary"] = summary


def phase_eval(rank, world, workdir, setup, results):
    """eval --dp nll, and the metric loops over the data mesh against the
    same loops without it."""
    import numpy as np
    import torch

    from vdiff_tpu_torch import eval as eval_cli
    from vdiff_tpu_torch.metrics.device_apply import apply_batched
    from vdiff_tpu_torch.metrics.precision_recall import ManifoldBuilder, calc_pr
    from vdiff_tpu_torch.parallel import create_mesh

    results["nll"] = eval_cli.main(setup["eval_args"] + ["--dp"])["nll"]
    mesh = create_mesh()
    rng = np.random.RandomState(9)  # the same inputs on every rank
    x = rng.randn(13, 4, 4, 3).astype(np.float32)
    w = torch.from_numpy(rng.randn(48, 5).astype(np.float32))
    fn = lambda b: torch.tanh(b.flatten(1) @ w)
    for bs in (4, 5, 13, 20):
        got = apply_batched(fn, x, bs, "cpu", mesh)
        assert np.array_equal(got, apply_batched(fn, x, bs, "cpu")), bs
    assert apply_batched(fn, x[:0], 4, "cpu", mesh).shape == (0, 5)
    f1, f2 = rng.randn(37, 16).astype(np.float16), rng.randn(29, 16).astype(np.float16)
    kw = dict(nhood_size=3, row_batch_size=10, col_batch_size=7)
    pr = {}
    for name, m in (("mesh", mesh), ("one", None)):
        a = ManifoldBuilder(features=f1, device="cpu", mesh=m, **kw).manifold
        b = ManifoldBuilder(features=f2, device="cpu", mesh=m, **kw).manifold
        pr[name] = (a.kth, b.kth, calc_pr(a, b, 10, 7, device="cpu", mesh=m))
    assert np.array_equal(pr["mesh"][0], pr["one"][0])
    assert np.array_equal(pr["mesh"][1], pr["one"][1])
    assert pr["mesh"][2] == pr["one"][2]
    results["pr"] = pr["mesh"][2]


def phase_evaluator(rank, world, workdir, setup, results):
    """train_lib.Evaluator on the DDP trainer's mesh, fed by its collective
    eval sampler (a numpy feature map, seeded target statistics)."""
    import numpy as np

    from vdiff_tpu_torch.train_lib import Evaluator

    trainer = _trainer(setup, distributed=True)
    feats = np.random.RandomState(42).randn(64, 8)
    evaluator = Evaluator("synthetic", eval_batch_size=5, max_eval_count=5, mesh=trainer.mesh,
                          feature_fn=lambda im: im.reshape(len(im), -1)[:, :8].astype(np.float64),
                          target_stats=(feats.mean(0), np.cov(feats, rowvar=False)),
                          device="cpu")
    results["fid"] = evaluator.eval(trainer.eval_sampler(0))["fid"]


def phase_train_cli(rank, world, workdir, setup, results):
    """The train CLI with --fsdp on every rank: one epoch of the synthetic
    smoke experiment, its sample grid and checkpoint written by rank 0."""
    from vdiff_tpu_torch import train

    smoke = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "vdiff_tpu_torch", "configs", "synthetic_smoke.json")
    results["train_cli"] = train.main(["--config-path", smoke, "--device", "cpu", "--fsdp",
                                       "--exp-dir", os.path.join(workdir, "exps")])


def _record_rows(fn):
    """``fn()`` with every conv's output rows, every GroupNorm's and
    resample's input rows recorded in call order; returns (out, record)."""
    import torch.nn.functional as F

    from vdiff_tpu_torch.ops import groupnorm

    record, saved = [], {name: getattr(F, name) for name in ("conv2d", "avg_pool2d",
                                                             "interpolate")}
    stats = groupnorm._stats

    def wrap(name):
        def call(x, *a, **k):
            out = saved[name](x, *a, **k)
            record.append((name, out.shape[2] if name == "conv2d" else x.shape[2]))
            return out
        return call

    def recorded_stats(x, *a, **k):
        record.append(("group_norm", x.shape[1]))  # NHWC
        return stats(x, *a, **k)

    for name in saved:
        setattr(F, name, wrap(name))
    groupnorm._stats = recorded_stats
    try:
        return fn(), record
    finally:
        for name, f in saved.items():
            setattr(F, name, f)
        groupnorm._stats = stats


def phase_tp_forward(rank, world, workdir, setup, results):
    """The one-rank forward and the TP, SP and TP+SP forwards of the same
    weights and inputs (rows and shapes recorded), each rank's parameter
    bytes under TP and the sharded parameters' shapes; then the refusals of
    the height shard (a gradient, a fused switch)."""
    import torch

    from vdiff_tpu_torch.parallel import (SpatialShardedUNet, state_bytes_per_device,
                                          tp_shard_model_)

    x, t, y = setup["inputs"][:3]
    with torch.inference_mode():
        out, plain_rows = _record_rows(lambda: _model(setup).eval()(x, t, y))
        tp = tp_shard_model_(_model(setup).eval())
        results["tp_out"] = tp(x, t, y)
        results["sp_out"], sp_rows = _record_rows(
            lambda: SpatialShardedUNet(_model(setup).eval())(x, t, y))
        results["tpsp_out"], tpsp_rows = _record_rows(
            lambda: SpatialShardedUNet(tp_shard_model_(_model(setup).eval()))(x, t, y))
    results.update(one_out=out, plain_rows=plain_rows, sp_rows=sp_rows, tpsp_rows=tpsp_rows,
                   tp_bytes=state_bytes_per_device(tp),
                   tp_shapes={k: tuple(p.shape) for k, p in tp.named_parameters()})
    refusals = {}
    wrapped = SpatialShardedUNet(_model(setup).eval())
    try:
        wrapped(x, t, y)
    except RuntimeError as e:
        refusals["grad"] = str(e)
    for switch in ("VDIFF_FUSED_CONV", "VDIFF_FUSED_GN"):
        os.environ[switch] = "1"
        try:
            with torch.inference_mode():
                wrapped(x, t, y)
        except ValueError as e:
            refusals[switch] = str(e)
        finally:
            del os.environ[switch]
    results["sp_refusals"] = refusals


def phase_tp_sample(rank, world, workdir, setup, results):
    """Four DDIM steps with CFG from the given x_T: one rank, --tp and
    --spatial-shard."""
    import torch

    from vdiff_tpu_torch.parallel import SpatialShardedUNet, tp_shard_model_

    x_T, y4 = setup["inputs"][3:]
    diffusion = _diffusion(setup)
    with torch.inference_mode():
        for name, fn in (("one", lambda m: m), ("tp", tp_shard_model_),
                         ("sp", SpatialShardedUNet)):
            results[f"sample_{name}"] = diffusion.p_sample(fn(_model(setup).eval()), x_T,
                                                           label=y4, use_ddim=True)


def phase_tp_generate(rank, world, workdir, setup, results):
    """generate --tp, --spatial-shard and both on every rank, and --tp and
    --spatial-shard with --progressive (rank 0's float samples or strips
    captured before the PNG writer quantises them), and --spatial-shard
    refusing a config whose lowest level does not split."""
    import numpy as np

    from vdiff_tpu_torch import generate

    write = generate.write_pngs
    progressive = ["--progressive", "--pred-freq", str(PROGRESSIVE_FREQ)]
    for name, flags in (("tp", ["--tp"]), ("sp", ["--spatial-shard"]),
                        ("tpsp", ["--tp", "--spatial-shard"]),
                        ("tp_progressive", ["--tp"] + progressive),
                        ("sp_progressive", ["--spatial-shard"] + progressive)):
        captured = []
        generate.write_pngs = lambda save_dir, x: (captured.append(np.array(x)),
                                                   write(save_dir, x))
        try:
            summary = generate.main(setup["generate_args"] + flags + [
                "--save-dir", os.path.join(workdir, f"gen_{name}")])
        finally:
            generate.write_pngs = write
        results[f"generate_{name}"] = np.concatenate(captured) if captured else None
        results[f"generate_{name}_summary"] = summary
    args = setup["generate_args"] + ["--spatial-shard"]
    args[args.index("--config-path") + 1] = setup["six_levels"]
    try:
        generate.main(args)
    except SystemExit as e:
        results["six_levels_refused"] = str(e)


# generate --progressive under the model-parallel modes: a snapshot every
# PROGRESSIVE_FREQ of the setup's 4 steps
PROGRESSIVE_FREQ = 2

PHASES = {
    "data": phase_data,
    "sample": phase_sample,
    "ddp": _parallel_step("ddp", dict(distributed=True)),
    "fsdp": _parallel_step("fsdp", dict(fsdp=True)),
    "hsdp": _parallel_step("hsdp", dict(fsdp_size=2)),
    "replicated": phase_replicated,
    "generate": phase_generate,
    "eval": phase_eval,
    "evaluator": phase_evaluator,
    "train_cli": phase_train_cli,
    "tp_forward": phase_tp_forward,
    "tp_sample": phase_tp_sample,
    "tp_generate": phase_tp_generate,
}


if __name__ == "__main__":
    main()
