"""The port's multi-rank paths on the CPU, two ranks over gloo
(vdiff_tpu_torch.parallel, train_lib, data, generate --dp, eval --dp).

One launch of tests/torch_parallel_worker.py runs every phase on two ranks
while this process computes the JAX package's steps on a 2-device data mesh
of the 8 CPU devices tests/conftest.py provides. The DDP and FSDP steps (CFG
on, two micro-batches, dropout off, the clip biting, JAX's own draws passed
in) are held against JAX's ``make_train_step`` and against the port's
one-rank step; FSDP checkpoints cross between two ranks and one process bit
for bit; the collective sampler, ``generate --dp`` and ``eval --dp`` give the
one-rank results; the per-rank loader gives the JAX loader's shards."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parallel_setup as S  # noqa: E402

PHASES = ("data", "sample", "ddp", "fsdp", "replicated", "generate", "eval", "evaluator",
          "train_cli")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("two_ranks")
    setup = S.write_setup(workdir)
    return setup, S.Ranks(workdir, 2, PHASES)


def _jax_step(fsdp):
    """JAX's ``make_train_step`` jitted on a 2-device data mesh, the state
    replicated or sharded by ``state_shardings``; returns (loss, pre-clip
    grads, params, EMA) in the port's layout. The grads are read off an
    optax transform chained before the optimizer that keeps its input."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vdiff_tpu.diffusion import GaussianDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule
    from vdiff_tpu.parallel import batch_sharding, create_mesh, replicated
    from vdiff_tpu.parallel.fsdp import state_shardings
    from vdiff_tpu.train_lib import TrainState, make_optimizer, make_train_step

    model, params = S.jax_model_and_params()
    diffusion = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **S.DIFFUSION)
    keep_grads = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                              lambda g, s, p=None: (g, g))
    tx = optax.chain(keep_grads, make_optimizer(grad_norm=S.GRAD_NORM, **S.OPTIMIZER))
    step_fn = make_train_step(model, diffusion, tx, timesteps=0, num_accum=S.NUM_ACCUM,
                              use_cfg=True, ema_decay=S.EMA_DECAY, use_ema=True)
    params = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                       ema_params=jax.tree.map(jnp.copy, params))
    mesh = create_mesh(jax.devices()[:2])
    sh = state_shardings(mesh, state, min_size=0) if fsdp else replicated(mesh)
    step = jax.jit(step_fn, in_shardings=(sh, batch_sharding(mesh, 4),
                                          NamedSharding(mesh, P("data")), None),
                   out_shardings=(sh, replicated(mesh)))
    x, y = S.global_batch()
    new, loss = step(jax.device_put(state, sh), x, y, jax.random.key(S.JAX_SEED))
    if fsdp:  # the state really was sharded
        assert any(not leaf.sharding.is_fully_replicated for leaf in jax.tree.leaves(new.params))
    return (float(loss), S.to_port(new.opt_state[0]), S.to_port(new.params),
            S.to_port(new.ema_params))


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_two_rank_step_matches_jax_step_on_a_two_device_mesh(ranks, mode):
    """The 2-rank DDP step against JAX's replicated step, the 2-rank FSDP step
    against JAX's ``shard_state`` step: loss, grads, params and EMA."""
    loss, grads, params, ema = _jax_step(fsdp=mode == "fsdp")
    setup, r = ranks
    res = r.results()
    got = res[0][mode]
    norm = S.check_step(got, loss, grads, params, ema)
    assert norm > S.GRAD_NORM  # the clip bit
    # every rank holds the same whole state after the step
    S.assert_same_state(res[1][mode]["params"], got["params"])
    assert res[1][mode]["loss"] == got["loss"]


def test_fsdp_step_matches_the_one_rank_step_and_shards_the_state(ranks):
    setup, r = ranks
    res = r.results()
    one = res[0]["one"]
    norm = S.check_step(res[0]["fsdp"], one["loss"], S.as_numpy(one["grads"]),
                        S.as_numpy(one["params"]), S.as_numpy(one["ema"]))
    assert norm > S.GRAD_NORM
    whole = 4 * sum(v.numel() * 4 for v in one["params"].values())  # params, EMA, 2 moments
    for rank_res in res:
        assert rank_res["fsdp"]["state_bytes"] <= 0.55 * whole


def test_fsdp_checkpoint_restores_in_one_process_bit_for_bit(ranks):
    """The checkpoint the two FSDP ranks wrote (one file, whole tensors)
    restores into a one-process trainer as the tensors the ranks held."""
    from tests.torch_parallel_worker import _trainer

    setup, r = ranks
    res = r.results()[0]
    one = _trainer(setup)
    one.load_checkpoint(ckpt_path=res["fsdp_ckpt"], ckpt_dir=os.path.dirname(res["fsdp_ckpt"]))
    S.assert_same_state({k: p.detach() for k, p in one.module.named_parameters()},
                        res["fsdp"]["params"])
    S.assert_same_state({k: p.detach() for k, p in one.ema_model.named_parameters()},
                        res["fsdp"]["ema"])
    S.assert_same_state(one.optimizer.state_dict(), res["fsdp_opt"])


def test_one_process_checkpoint_restores_into_two_fsdp_ranks_bit_for_bit(ranks):
    setup, r = ranks
    res = r.results()
    for rank_res in res:
        got = rank_res["restored"]
        S.assert_same_state(got["params"], res[0]["one"]["params"])
        S.assert_same_state(got["ema"], res[0]["one"]["ema"])
        S.assert_same_state(got["opt"], res[0]["one_opt"])
        assert got["epoch_step"] == (1, 0)


def test_collective_sample_fn_is_the_one_rank_sampler_on_every_rank(ranks):
    """DDP's and FSDP's (gathered EMA) collective sampler on a batch of 9,
    which two ranks split padded: the same samples on both ranks, those of a
    one-rank trainer (ancestral, CFG, labels)."""
    setup, r = ranks
    res = r.results()
    ref = res[0]["sample_one"]
    assert ref.shape == (9,) + S.SHAPE and np.isfinite(ref).all()
    for mode in ("sample_ddp", "sample_fsdp"):
        assert np.array_equal(res[0][mode], res[1][mode]), mode
        np.testing.assert_allclose(res[0][mode], ref, rtol=0, atol=1e-5, err_msg=mode)


def test_generate_dp_equals_one_rank(ranks, monkeypatch, tmp_path):
    """generate --dp on two ranks writes the samples of a one-rank run,
    within 1e-5 before the PNG quantisation (ancestral sampling with CFG, a
    last batch shorter than the batch size)."""
    from vdiff_tpu_torch import generate

    setup, r = ranks
    captured = []
    monkeypatch.setattr(generate, "write_pngs", lambda d, x: captured.append(np.array(x)))
    generate.main(setup["generate_args"] + ["--save-dir", str(tmp_path)])
    ref = np.concatenate(captured)
    res = r.results()
    assert ref.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(res[0]["generate"], ref, rtol=0, atol=1e-5)
    assert res[1]["generate"] is None  # rank 0 alone writes
    assert res[0]["generate_summary"]["images"] == 6


def test_eval_dp_nll_and_metric_loops_equal_one_rank(ranks, capsys):
    """eval --dp's bits/dim (each rank its rows of each batch, the whole
    batch's noise) is the one-rank value; the apply and P&R loops over the
    mesh equal the one-device loops inside the workers."""
    from vdiff_tpu_torch import eval as eval_cli

    setup, r = ranks
    ref = eval_cli.main(setup["eval_args"])["nll"]
    res = r.results()
    assert np.isfinite(ref)
    for rank_res in res:
        np.testing.assert_allclose(rank_res["nll"], ref, rtol=1e-6)
        assert rank_res["pr"] == res[0]["pr"]


def test_per_rank_loader_matches_jax_dataloader_and_a_missing_dataset_fails_on_every_rank(ranks):
    from vdiff_tpu import data as jdata

    setup, r = ranks
    res = r.results()
    ds = jdata._build_dataset("synthetic", "", "train")
    flipped = jdata._build_dataset("synthetic", "", "train")
    flipped.random_flip = True
    for rank, rank_res in enumerate(res):
        ref = jdata.DataLoader(ds, batch_size=8, seed=3, process_index=rank, process_count=2)
        ref.set_epoch(1)
        np.testing.assert_array_equal(rank_res["data_indices"], ref._epoch_indices())
        # the rank's flip stream: the first batch of epoch 1, images and labels
        ref = jdata.DataLoader(flipped, batch_size=8, seed=3, process_index=rank,
                               process_count=2)
        ref.set_epoch(1)
        rx, ry = next(iter(ref))
        x, y = rank_res["data_flipped_batch"]
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        assert rank_res["missing_raised"]


def test_evaluator_on_the_training_mesh_is_the_one_rank_fid(ranks):
    """The in-training FID with the collective eval sampler: the same number
    on both ranks, that of one rank sampling the same batches."""
    from tests.torch_parallel_worker import _trainer
    from vdiff_tpu_torch.train_lib import Evaluator

    setup, r = ranks
    res = r.results()
    feats = np.random.RandomState(42).randn(64, 8)
    ref = Evaluator("synthetic", eval_batch_size=5, max_eval_count=5, device="cpu",
                    feature_fn=lambda im: im.reshape(len(im), -1)[:, :8].astype(np.float64),
                    target_stats=(feats.mean(0), np.cov(feats, rowvar=False))
                    ).eval(_trainer(setup).eval_sampler(0))["fid"]
    assert res[0]["fid"] == res[1]["fid"]
    np.testing.assert_allclose(res[0]["fid"], ref, rtol=1e-5)


def test_train_cli_with_fsdp_on_two_ranks(ranks):
    """train --fsdp: one run directory (rank 0's clock), the world-divided
    batch of each rank's shard (8 steps of 32 a rank), rank 0's grid and
    single-card checkpoint, the summary it wrote."""
    import json

    from vdiff_tpu_torch.factory import load_weights
    from vdiff_tpu_torch.models.unet import UNet

    setup, r = ranks
    res = r.results()
    a, b = res[0]["train_cli"], res[1]["train_cli"]
    assert a["exp_dir"] == b["exp_dir"] and a["world_size"] == 2
    assert len(os.listdir(os.path.dirname(a["exp_dir"]))) == 1
    assert a["steps"] == b["steps"] == 8 and a["losses"] == b["losses"]
    assert np.isfinite(a["loss"]) and os.path.exists(os.path.join(a["image_dir"], "1.png"))
    with open(os.path.join(a["exp_dir"], "summary.json")) as f:
        assert json.load(f)["losses"] == a["losses"]
    ckpt = torch.load(os.path.join(a["ckpt_dir"], "ckpt_last.pt"), weights_only=True)
    model = UNet(in_channels=3, hid_channels=32, out_channels=3, ch_multipliers=(1, 1),
                 num_res_blocks=1, apply_attn=(False, True), num_heads=1, num_classes=10)
    load_weights(model, ckpt["ema"]["shadow"])
