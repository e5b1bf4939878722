"""The port's training runtime on the CPU: dropout's law, gradient
accumulation, resume from a checkpoint, the data loader against the JAX
package's, checkpoint naming and retention, and the train CLI end to end
(vdiff_tpu_torch.models.layers, train_lib, data, train)."""

import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

pytest_plugins = ["torch_limits"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "vdiff_tpu_torch", "configs", "synthetic_smoke.json")


def test_efficient_dropout_law():
    """Keep iff a uniform 16-bit integer ≥ round(rate·2¹⁶), survivors scaled
    by exactly 1/keep_prob; rate → 1 drops all; off outside training."""
    from vdiff_tpu_torch.models.layers import EfficientDropout

    x = torch.ones(1 << 20)
    drop = EfficientDropout(0.2)
    out = drop(x, True, torch.Generator().manual_seed(0))
    keep_prob = 1.0 - round(0.2 * 65536) / 65536
    kept = out != 0
    assert abs(kept.float().mean().item() - keep_prob) < 1e-3
    assert torch.equal(out[kept], torch.full_like(out[kept], 1.0 / keep_prob))
    assert torch.equal(out, drop(x, True, torch.Generator().manual_seed(0)))  # the generator decides
    assert torch.equal(drop(x, False), x) and torch.equal(EfficientDropout(0.0)(x, True), x)
    assert not bool(EfficientDropout(1.0)(x, True).any())
    xb = torch.ones(8, dtype=torch.bfloat16)
    assert drop(xb, True, torch.Generator().manual_seed(1)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="Generator"):
        drop(x, True)


def _tiny_unet(drop_rate=0.0, seed=0):
    from vdiff_tpu_torch.models.unet import UNet

    return UNet(in_channels=3, hid_channels=32, out_channels=3, ch_multipliers=(1,),
                num_res_blocks=1, apply_attn=(True,), num_heads=1, num_classes=10,
                drop_rate=drop_rate, generator=torch.Generator().manual_seed(seed))


def _diffusion():
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    return GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), model_out_type="v",
                             reweight_type="snr_trunc", p_uncond=0.1, sample_timesteps=2)


def _batch(B=4, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32))
    return x, torch.from_numpy(rng.randint(1, 11, B).astype(np.int64))


def test_grad_accumulation_averages_the_micro_grads():
    """num_accum=2 on a batch gives the mean of the two halves' gradients and
    losses (lr 0 and no clipping, so the grads stay readable)."""
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    model = _tiny_unet()
    opt = Optimizer(model.parameters(), lr=0.0, grad_norm=0.0)
    x, y = _batch()
    rng = np.random.RandomState(1)
    draws = [{"t": torch.from_numpy(rng.rand(2).astype(np.float32)),
              "noise": torch.from_numpy(rng.randn(2, 8, 8, 3).astype(np.float32)),
              "keep": torch.tensor([True, False])} for _ in range(2)]
    one = make_train_step(model, _diffusion(), opt, 0, num_accum=1, use_cfg=True)
    halves = []
    for i in range(2):
        loss = one(x[2 * i:2 * i + 2], y[2 * i:2 * i + 2], 0, 0, draws=[draws[i]])
        halves.append((loss, [p.grad.clone() for p in model.parameters()]))
    two = make_train_step(model, _diffusion(), opt, 0, num_accum=2, use_cfg=True)
    loss = two(x, y, 0, 0, draws=draws)
    torch.testing.assert_close(loss, (halves[0][0] + halves[1][0]) / 2)
    for p, g0, g1 in zip(model.parameters(), halves[0][1], halves[1][1]):
        torch.testing.assert_close(p.grad, (g0 + g1) / 2, rtol=1e-5, atol=1e-7)


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """Two steps straight equal one step, a checkpoint, a fresh trainer
    restored from it, and the second step: params, EMA and step, bit for bit.
    The draws (t, noise, CFG mask, dropout bits) follow from (seed, step)."""
    from vdiff_tpu_torch.train_lib import CheckpointManager, Trainer

    def trainer():
        return Trainer(_tiny_unet(drop_rate=0.1), _diffusion(), timesteps=0, epochs=1,
                       trainloader=None, optimizer_config=dict(lr=1e-3, warmup=2),
                       use_cfg=True, use_ema=True, shape=(8, 8, 3), seed=3, device="cpu",
                       ema_decay=0.9)

    (x0, y0), (x1, y1) = _batch(seed=0), _batch(seed=1)
    a = trainer()
    a.step(x0, y0)
    a.step(x1, y1)
    b = trainer()
    b.step(x0, y0)
    b.ckpt_manager = CheckpointManager(str(tmp_path))
    path = b.save_checkpoint(epoch=1)
    c = trainer()
    c.load_checkpoint(ckpt_path=path, ckpt_dir=str(tmp_path))
    assert (c.start_epoch, c.host_step, c.optimizer.count) == (1, 1, 1)
    c.step(x1, y1)
    for m_a, m_c in ((a.model, c.model), (a.ema_model, c.ema_model)):
        for (k, pa), pc in zip(m_a.state_dict().items(), m_c.state_dict().values()):
            assert torch.equal(pa, pc), k
    assert not torch.equal(a.model.in_conv.weight, b.model.in_conv.weight)


def test_dataloader_matches_jax_package_over_two_epochs():
    from vdiff_tpu import data as jdata
    from vdiff_tpu_torch import data

    for flip in (False, True):
        ref_ds = jdata._build_dataset("synthetic", "", "train")
        ds = data._build_dataset("synthetic", "", "train")
        np.testing.assert_array_equal(ds.images, ref_ds.images)
        ref_ds.random_flip = ds.random_flip = flip
        ref = jdata.DataLoader(ref_ds, batch_size=96, seed=5)
        got = data.DataLoader(ds, batch_size=96, seed=5)
        assert len(got) == len(ref) == 512 // 96
        for epoch in range(2):
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
            n = 0
            for (x, y), (rx, ry) in zip(got, ref):
                assert x.dtype == np.float32 and x.shape == (96, 32, 32, 3)
                np.testing.assert_array_equal(x, rx)
                np.testing.assert_array_equal(y, ry)
                n += 1
            assert n == len(ref)


def test_normalize_flip_matches_native():
    from vdiff_tpu import native
    from vdiff_tpu_torch.data import normalize_flip

    img = np.random.RandomState(0).randint(0, 256, (3, 4, 5, 3), dtype=np.uint8)
    img[0, 0, 0] = (0, 255, 128)
    flips = np.array([True, False, True])
    np.testing.assert_array_equal(normalize_flip(img, flips), native.normalize_flip(img, flips))
    np.testing.assert_array_equal(normalize_flip(img), native.normalize_flip(img))
    assert normalize_flip(img)[0, 0, 0, 1] == 1.0


def test_checkpoint_manager_naming_retention_and_latest(tmp_path):
    from vdiff_tpu_torch.train_lib import CheckpointManager

    m = CheckpointManager(str(tmp_path), max_ckpts_kept=2)
    assert m.latest_path() is None
    for epoch in (1, 2, 3):
        m.save({"epoch": epoch}, epoch, epochs=10)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2.pt", "ckpt_3.pt"]  # the oldest went
    (tmp_path / "ckpt_9.pt.123.tmp").write_bytes(b"")  # an interrupted save
    (tmp_path / "ckpt_best.pt").write_bytes(b"")
    assert m.latest_path() == str(tmp_path / "ckpt_3.pt")
    m.save({"epoch": 10}, 10, epochs=12)
    assert m.latest_path() == str(tmp_path / "ckpt_10.pt")  # numeric, not lexical
    m.save({"epoch": 12}, 12, epochs=12)
    assert m.latest_path() == str(tmp_path / "ckpt_last.pt")
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt")) == [
        "ckpt_10.pt", "ckpt_best.pt", "ckpt_last.pt"]
    assert torch.load(m.latest_path(), weights_only=True) == {"epoch": 12}


def test_train_cli_on_cpu_writes_a_checkpoint_generate_samples_from(tmp_path, monkeypatch):
    """synthetic_smoke at 32 images and batch 16: two steps, the epoch-end
    sample grid and ckpt_last.pt, which the port's generate samples from."""
    from vdiff_tpu_torch import data, generate, train

    monkeypatch.setitem(data.DATA_INFO["synthetic"], "train_size", 32)
    summary = train.main(["--config-path", SMOKE, "--device", "cpu", "--batch-size", "16",
                          "--exp-dir", str(tmp_path / "exps")])
    assert summary["steps"] == 2 and math.isfinite(summary["loss"])
    assert os.listdir(summary["image_dir"]) == ["1.png"]
    ckpt = os.path.join(summary["ckpt_dir"], "ckpt_last.pt")
    state = torch.load(ckpt, weights_only=True)
    assert (state["epoch"], state["step"]) == (1, 2) and state["ema"]["shadow"].keys() == state["model"].keys()
    out = generate.main(["--config-path", SMOKE, "--ckpt-path", ckpt, "--device", "cpu",
                         "--use-ema", "--use-ddim", "--sample-timesteps", "2", "--total-size", "2",
                         "--batch-size", "2", "--save-dir", str(tmp_path / "gen")])
    assert out["images"] == 2 and out["finite"]


@pytest.mark.parametrize("flags,flag", [
    pytest.param(["--distributed"], "--distributed", id="flags0-A10"),
    pytest.param(["--fsdp"], "--fsdp", id="flags1-A10"),
    pytest.param(["--fsdp-size", "2"], "--fsdp-size", id="flags2-A10")])
def test_train_cli_refuses_what_is_not_ported(flags, flag, monkeypatch):
    """The multi-GPU flags (ROADMAP A10, ported) run under torchrun; a
    process started without its RANK and WORLD_SIZE stops, naming the flag
    and the launcher, before anything is built."""
    from vdiff_tpu_torch.train import main

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=f"{flag} runs one process per device under torchrun"):
        main(["--config-path", SMOKE, "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,policy", [(["--remat"], None),
                                          (["--remat-policy", "conv"], "conv")])
def test_train_cli_trains_with_remat(tmp_path, monkeypatch, flags, policy):
    """--remat and --remat-policy conv reach the UNet the CLI builds, whose
    training forward then runs its blocks through the checkpoint, and the
    run takes its step (synthetic_smoke at 16 images and batch 16, no sample
    grid or checkpoint; torch on two threads, as the suite runs six
    workers)."""
    from vdiff_tpu_torch import data, train
    from vdiff_tpu_torch.models import unet

    monkeypatch.setitem(data.DATA_INFO["synthetic"], "train_size", 16)
    built, regions = [], []
    build_unet = train.build_unet
    monkeypatch.setattr(train, "build_unet", lambda *a, **k: built.append(build_unet(*a, **k))
                        or built[-1])
    checkpoint_block = unet.checkpoint_block
    monkeypatch.setattr(unet, "checkpoint_block",
                        lambda *a: regions.append(a[-1]) or checkpoint_block(*a))
    summary = train.main(["--config-path", SMOKE, "--device", "cpu", "--batch-size", "16",
                          "--num-save-images", "0", "--max-ckpts-kept", "0",
                          "--exp-dir", str(tmp_path / "exps"), *flags])
    (model,) = built
    assert model.remat and model.remat_policy == policy
    assert summary["steps"] == 1 and math.isfinite(summary["loss"])
    # a training forward of synthetic_smoke's UNet wraps 8 blocks (3 down, 5 up)
    assert regions == [policy] * 8


def test_train_cli_accepts_eval(tmp_path, monkeypatch):
    """--eval and --eval-intv reach the trainer: an Evaluator is built and
    handed to Trainer.train, the interval to the Trainer (no refusal)."""
    from vdiff_tpu_torch import train

    got = {}

    def fake_train(self, ckpt_dir=None, image_dir=None, use_ddim=False, evaluator=None):
        got.update(evaluator=evaluator, eval_intv=self.eval_intv)
        return {}

    monkeypatch.setattr(train.Trainer, "train", fake_train)
    train.main(["--config-path", SMOKE, "--device", "cpu", "--eval", "--eval-intv", "3",
                "--exp-dir", str(tmp_path / "exps")])
    assert isinstance(got["evaluator"], train.Evaluator) and got["eval_intv"] == 3
    assert got["evaluator"].diffusion.w_guide == 0.0  # a CFG model evaluates at w=0


def test_train_cli_refuses_missing_cuda(monkeypatch):
    from vdiff_tpu_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        main(["--config-path", SMOKE, "--prng-impl", "threefry2x32"])
