"""The port's eval CLI (``python -m vdiff_tpu_torch.eval``), the fid CLI and
the in-training FID on the CPU: every root ``eval.py`` option parses, ``nll``
on a tiny checkpoint (one trained with the kl loss and learned variances
too), ``fid``/``is``/``pr`` on a few PNGs with fabricated release-format
weights, pre-written statistics and a pre-written manifold cache, each
message the root CLI prints, the ``--dp`` refusal, the ``Evaluator`` against
the JAX package's, and ``train --eval``."""

import json
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests.test_torch_celeba_data import _tiny_celeba_config, celeba_root  # noqa: E402,F401
from tests.test_torch_cli_flags import _root_options  # noqa: E402
from tests.torch_parity import metric_state_dict  # noqa: E402

pytest_plugins = ["torch_limits"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "vdiff_tpu_torch", "configs", "synthetic_smoke.json")
EVAL_OPTIONS = _root_options("eval")


def test_the_root_eval_parser_was_read():
    flags = {f for f, _ in EVAL_OPTIONS}
    assert {"--metrics", "--is-splits", "--dp", "--ckpt-path", "--device"} <= flags
    assert len(flags) == 21


@pytest.mark.parametrize("flag,value", EVAL_OPTIONS, ids=[f for f, _ in EVAL_OPTIONS])
def test_port_eval_parser_accepts_the_root_flag(flag, value):
    from vdiff_tpu_torch.eval import build_parser

    args = build_parser().parse_args([flag, *value])
    parsed = getattr(args, flag.lstrip("-").replace("-", "_"))
    if value:
        want = [value[0]] if flag == "--metrics" else value[0]
        assert parsed == want or str(parsed) in (value[0], "1.0"), parsed
    else:
        assert parsed is True
    assert build_parser().parse_args([]).device == "cuda"


def _smoke_ckpt(path, config=SMOKE, seed=0):
    """A reference-format .pt of the synthetic_smoke UNet (conditional),
    random weights with the zero-init layers perturbed."""
    from vdiff_tpu_torch.factory import build_unet, load_experiment_config

    cfg, _ = load_experiment_config(config)
    gen = torch.Generator().manual_seed(seed)
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=10, multitags=False, generator=gen,
                       model_var_type=cfg["diffusion"]["model_var_type"])
    with torch.no_grad():
        for p in model.parameters():
            if not bool(p.any()):
                p.normal_(0.0, 0.05, generator=gen)
    sd = model.state_dict()
    torch.save({"model": sd, "ema": {"shadow": sd}}, path)
    return path


def test_nll_on_a_tiny_checkpoint(tmp_path, capsys):
    """40 of synthetic's test images, batches of 16: two batches, the tail of
    8 dropped and said so; the labels flow (a class_embed checkpoint); the
    same seed gives the same number."""
    from vdiff_tpu_torch.eval import main

    ckpt = _smoke_ckpt(str(tmp_path / "m.pt"))
    argv = ["--device", "cpu", "--dataset", "synthetic", "--metrics", "nll", "--config-path",
            SMOKE, "--ckpt-path", ckpt, "--eval-batch-size", "16", "--eval-total-size", "40",
            "--use-ema"]
    out = main(argv)
    text = capsys.readouterr().out
    assert "nll computed over 32/40 samples (tail < batch size dropped)" in text
    assert math.isfinite(out["nll"]) and 0 < out["nll"] < 100
    assert f"NLL: {out['nll']}" in text
    assert main(argv)["nll"] == out["nll"]


def test_nll_on_a_celeba_checkpoint(celeba_root, tmp_path):
    """celeba: the whole split (6 written JPEGs) in batches of 3, multi-hot
    tags as labels, heads of 32 on the pack1 routes (their CPU twins)."""
    from vdiff_tpu_torch.eval import main
    from vdiff_tpu_torch.factory import build_unet, load_experiment_config

    config = _tiny_celeba_config(tmp_path)
    cfg, _ = load_experiment_config(config)
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=40, multitags=True, generator=torch.Generator().manual_seed(1))
    ckpt = str(tmp_path / "celeba.pt")
    torch.save({"model": model.state_dict()}, ckpt)
    out = main(["--device", "cpu", "--dataset", "celeba", "--root", celeba_root, "--metrics",
                "nll", "--config-path", config, "--ckpt-path", ckpt, "--eval-batch-size", "3"])
    assert math.isfinite(out["nll"]) and out["nll"] > 0


def test_messages_and_refusals(tmp_path, capsys, monkeypatch):
    from vdiff_tpu_torch.eval import main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "imgs").mkdir()
    out = main(["--device", "cpu", "--dataset", "synthetic", "--metrics", "nll", "bogus", "fid",
                "--eval-dir", str(tmp_path / "imgs")])
    text = capsys.readouterr().out
    assert out == {"nll": "nll requires --config-path and --ckpt-path"}
    assert "Dataset: synthetic" in text
    assert "NLL: nll requires --config-path and --ckpt-path" in text
    assert "Unsupported metric 'bogus'! Ignore." in text
    assert f"FID skipped: no images found under '{tmp_path / 'imgs'}'" in text
    with pytest.raises(SystemExit, match="--dp runs one process per device under torchrun"):
        main(["--device", "cpu", "--dp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        main(["--metrics", "is"])


@pytest.fixture
def weights_cwd(tmp_path, monkeypatch):
    """cwd = tmp_path with fabricated release-format Inception and VGG16
    files in ./precomputed (a search directory of both loaders) and 4 PNGs
    in ./imgs."""
    from PIL import Image

    from vdiff_tpu_torch.metrics import inception, vgg

    monkeypatch.chdir(tmp_path)
    pre = tmp_path / "precomputed"
    pre.mkdir()
    for net, name in (("inception", inception.FID_WEIGHTS_FILENAME),
                      ("vgg16", vgg.VGG_FILENAMES[1])):
        torch.save(metric_state_dict(net)[1], pre / name)
    (tmp_path / "imgs").mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)).save(
            tmp_path / "imgs" / f"{i}.png")
    return tmp_path


def test_fid_is_pr_with_fabricated_weights(weights_cwd, capsys):
    """Statistics and the P&R manifold cache pre-written from the folder
    itself: FID ≈ 0 and P&R = (1, 1) against itself; IS finite and ≥ 1. The
    fid CLI writes the statistics (each FID is a 2048² sqrtm, ~10 s here)."""
    from vdiff_tpu_torch.data import ImageFolder
    from vdiff_tpu_torch.eval import main
    from vdiff_tpu_torch.metrics import fid
    from vdiff_tpu_torch.metrics.precision_recall import ManifoldBuilder

    imgs = str(weights_cwd / "imgs")
    fid.main([imgs, "precomputed/fid_stats_synthetic.npz", "--save-stats", "--device", "cpu"])
    # the eval CLI's own builder settings (--eval-batch-size 4, k=2)
    ManifoldBuilder(data=ImageFolder(imgs), extr_batch_size=4, nhood_size=2, device="cpu").save(
        "precomputed/pr_manifold_synthetic_train.npz")
    out = main(["--device", "cpu", "--dataset", "synthetic", "--metrics", "fid", "is", "pr",
                "--eval-dir", imgs, "--eval-batch-size", "4", "--is-splits", "2",
                "--nhood-size", "2"])
    text = capsys.readouterr().out
    # 4 images give a covariance of rank 3 in 2048 dims; sqrtm's error on its
    # zero eigenvalues is ~sqrt(f64 eps)·|Σ|, ~1e-5 here
    assert abs(out["fid"]) < 1e-4, out
    assert out["pr"] == "1.00000/1.00000"
    mean, std = (float(v) for v in out["is"].split(" +/- "))
    assert math.isfinite(mean) and mean >= 1.0 and math.isfinite(std)
    for metric in ("FID", "IS", "PR"):
        assert f"{metric}: {out[metric.lower()]}" in text


def test_missing_weights_skip_each_metric(tmp_path, capsys, monkeypatch):
    from PIL import Image

    from vdiff_tpu_torch.eval import main
    from vdiff_tpu_torch.metrics import fid, inception, vgg

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(inception, "_SEARCH_DIRS", ("precomputed",))
    monkeypatch.setattr(vgg, "_SEARCH_DIRS", ("precomputed",))
    (tmp_path / "imgs").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "imgs" / "a.png")
    out = main(["--device", "cpu", "--dataset", "synthetic", "--metrics", "fid", "is", "pr",
                "--eval-dir", str(tmp_path / "imgs")])
    text = capsys.readouterr().out
    assert out == {}
    assert "FID skipped: Precomputed FID statistics 'fid_stats_synthetic.npz' not found" in text
    assert f"IS skipped: FID InceptionV3 weights '{inception.FID_WEIGHTS_FILENAME}'" in text
    assert "PR skipped: VGG16 weights not found" in text
    with pytest.raises(SystemExit, match="FID skipped: FID InceptionV3 weights"):
        fid.main([str(tmp_path / "imgs"), "s.npz", "--save-stats", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--dp runs one process per device under torchrun"):
        fid.main(["a", "b", "--dp", "--device", "cpu"])


def test_evaluator_matches_jax_evaluator():
    """Fixed images through the same numpy feature map and target
    statistics: the port's Evaluator gives the JAX Evaluator's FID; without
    statistics both skip with the same message."""
    from vdiff_tpu.train_lib import Evaluator as JaxEvaluator
    from vdiff_tpu_torch.train_lib import Evaluator

    rng = np.random.RandomState(4)
    w = rng.randn(4 * 4 * 3, 8) / 10
    feature_fn = lambda x: np.asarray(x, np.float64).reshape(len(x), -1) @ w
    images = rng.uniform(-1, 1, (5, 4, 4, 3)).astype(np.float32)
    target = (rng.randn(8) * 0.1, np.eye(8) * 0.5)
    calls = []

    def sample_fn(b, diffusion):
        calls.append((b, diffusion))
        return images[:b]

    kw = dict(dataset="synthetic", diffusion="d", eval_batch_size=5, max_eval_count=10,
              feature_fn=feature_fn, target_stats=target)
    got = Evaluator(device="cpu", **kw).eval(sample_fn)
    ref = JaxEvaluator(**kw).eval(sample_fn)
    assert got == ref and math.isfinite(got["fid"])
    assert calls == [(5, "d")] * 6  # 3 batches each: max_eval_count + one batch
    logs = []
    assert Evaluator(dataset="synthetic", precomputed_dir="/nonexistent", device="cpu").eval(
        sample_fn, logs.append) == {}
    assert logs[0].startswith("FID skipped: Precomputed FID statistics 'fid_stats_synthetic.npz'")


def test_train_eval_accepted_and_skips_without_statistics(tmp_path, capsys, monkeypatch):
    """train --eval: accepted; with no statistics the hook logs the skip and
    the run trains on."""
    from vdiff_tpu_torch import data, train

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(data.DATA_INFO["synthetic"], "train_size", 16)
    summary = train.main(["--config-path", SMOKE, "--device", "cpu", "--batch-size", "16",
                          "--exp-dir", str(tmp_path / "exps"), "--eval", "--eval-intv", "1"])
    text = capsys.readouterr().out
    assert "FID skipped: Precomputed FID statistics 'fid_stats_synthetic.npz' not found" in text
    assert summary["steps"] == 1 and math.isfinite(summary["loss"]) and summary["eval"] == {
        "loss": summary["loss"]}


def test_train_eval_hook_feeds_the_evaluator(tmp_path, monkeypatch):
    """The hook's sampler: the evaluation diffusion (w=0), conditional
    labels in [1, K], a fresh draw each batch; its FID lands in the
    checkpoint's extra."""
    from vdiff_tpu_torch import data, train, train_lib

    monkeypatch.setitem(data.DATA_INFO["synthetic"], "train_size", 16)
    seen = []

    class Recording(train_lib.Evaluator):
        def __init__(self, dataset, diffusion=None, device="cuda"):
            super().__init__(dataset, diffusion, eval_batch_size=3, max_eval_count=3,
                             feature_fn=lambda x: np.asarray(x, np.float64).reshape(len(x), -1)[:, :4],
                             target_stats=(np.zeros(4), np.eye(4)), device=device)

        def eval(self, sample_fn, logger=print):
            def recorded(b, d):
                seen.append((d.w_guide, sample_fn(b, d)))
                return seen[-1][1]
            return super().eval(recorded, logger)

    monkeypatch.setattr(train, "Evaluator", Recording)
    summary = train.main(["--config-path", SMOKE, "--device", "cpu", "--batch-size", "16",
                          "--exp-dir", str(tmp_path / "exps"), "--eval", "--eval-intv", "1"])
    assert len(seen) == 2 and all(w == 0.0 for w, _ in seen)
    assert not np.array_equal(seen[0][1], seen[1][1])
    assert math.isfinite(summary["eval"]["fid"])
    ckpt = torch.load(os.path.join(summary["ckpt_dir"], "ckpt_last.pt"), weights_only=True)
    assert ckpt["extra"]["fid"] == summary["eval"]["fid"]


def test_each_checkpoint_keeps_its_own_epochs_results(tmp_path, monkeypatch):
    """Three epochs, an evaluation every second and a checkpoint every epoch:
    the evaluated epoch's checkpoint holds its FID and loss; the others hold
    their own loss and no FID; the summary keeps the last evaluation."""
    from vdiff_tpu_torch import data, train

    monkeypatch.setitem(data.DATA_INFO["synthetic"], "train_size", 16)
    evals = []

    class Counting:
        def __init__(self, dataset, diffusion=None, device="cuda"):
            pass

        def eval(self, sample_fn, logger=print):
            evals.append(len(evals) + 1.5)
            return {"fid": evals[-1]}

    monkeypatch.setattr(train, "Evaluator", Counting)
    summary = train.main(["--config-path", SMOKE, "--device", "cpu", "--batch-size", "16",
                          "--exp-dir", str(tmp_path / "exps"), "--eval", "--eval-intv", "2",
                          "--epochs", "3", "--ckpt-intv", "1", "--max-ckpts-kept", "3",
                          "--num-save-images", "0"])
    extra = [torch.load(os.path.join(summary["ckpt_dir"], f"ckpt_{e}.pt"),
                        weights_only=True)["extra"] for e in (1, 2, "last")]
    assert evals == [1.5]
    assert set(extra[0]) == set(extra[2]) == {"loss"} and extra[1].keys() == {"loss", "fid"}
    assert extra[1]["fid"] == 1.5 and summary["eval"] == extra[1]
    assert extra[2]["loss"] == summary["loss"]
    assert len({e["loss"] for e in extra}) == 3


def test_kl_learned_variance_trains_and_evaluates(tmp_path, monkeypatch):
    """loss_type="kl" with learned variances through the train CLI (the UNet
    built with 2×C outputs), then the eval CLI's nll on its checkpoint."""
    from vdiff_tpu_torch import data, train
    from vdiff_tpu_torch.eval import main

    with open(SMOKE) as f:
        cfg = json.load(f)
    cfg["diffusion"].update(loss_type="kl", model_var_type="learned")
    config = str(tmp_path / "kl.json")
    with open(config, "w") as f:
        json.dump(cfg, f)
    monkeypatch.setitem(data.DATA_INFO["synthetic"], "train_size", 16)
    summary = train.main(["--config-path", config, "--device", "cpu", "--batch-size", "16",
                          "--exp-dir", str(tmp_path / "exps")])
    assert summary["steps"] == 1 and math.isfinite(summary["loss"])
    ckpt = os.path.join(summary["ckpt_dir"], "ckpt_last.pt")
    assert torch.load(ckpt, weights_only=True)["model"]["out_conv.2.weight"].shape[0] == 6
    out = main(["--device", "cpu", "--dataset", "synthetic", "--metrics", "nll", "--config-path",
                config, "--ckpt-path", ckpt, "--eval-batch-size", "16", "--eval-total-size", "16"])
    assert math.isfinite(out["nll"])
