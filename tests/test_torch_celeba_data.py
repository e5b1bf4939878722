"""The port's CelebA data path and CLIs on the CPU: the attribute tables, the
loader (crop 148×148 at (40, 15) → 64×64 PIL-BILINEAR, flip, normalise) bit
for bit against the JAX package's, the multi-tag label stream of the generate
CLI against the JAX CLI's, and both CLIs end to end on a tiny CelebA tree
that the tests write with PIL; and the twins of tests/test_native.py's resize
and normalize cases and of the JAX package's 2-D toy-data helpers (its
histogram and discrete KL too)."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")
import torch  # noqa: E402


@pytest.fixture
def celeba_root(tmp_path):
    """Six random 218×178 JPEGs, a round-robin split and 40 ±1 attributes."""
    base = tmp_path / "celeba"
    img_dir = base / "img_align_celeba"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = [f"{i:06d}.jpg" for i in range(6)]
    for name in names:
        Image.fromarray(rng.randint(0, 256, (218, 178, 3), np.uint8)).save(img_dir / name)
    with open(base / "list_eval_partition.txt", "w") as f:
        f.writelines(f"{n} {i % 3}\n" for i, n in enumerate(names))
    with open(base / "list_attr_celeba.txt", "w") as f:
        f.write("6\n" + " ".join(f"Attr_{k}" for k in range(40)) + "\n")
        for n in names:
            f.write(n + "  " + " ".join(f"{v:d}" for v in rng.choice([-1, 1], size=40)) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("split", ["all", "train", "test"])
def test_celeba_index_matches_jax(celeba_root, split):
    from vdiff_tpu.data import load_celeba_index as jax_index
    from vdiff_tpu_torch.data import load_celeba_index

    names, attr, attr_names = load_celeba_index(celeba_root, split)
    ref = jax_index(celeba_root, split)
    assert names == ref[0] and attr_names == ref[2]
    np.testing.assert_array_equal(attr, ref[1])
    assert attr.dtype == np.float32 and set(np.unique(attr)) <= {0.0, 1.0}


def test_celeba_loader_bit_equal_to_jax(celeba_root):
    """load_batch and the epoch loader's (x, y), with flips, equal the JAX
    package's bit for bit; the crop-resize also equals PIL's own."""
    from vdiff_tpu import data as jdata
    from vdiff_tpu_torch import data

    ds = data._build_dataset("celeba", celeba_root, "all", num_workers=2)
    ref_ds = jdata._build_dataset("celeba", celeba_root, "all")
    idx = np.array([0, 3, 5])
    batch = ds.load_batch(idx)
    assert batch.shape == (3, 64, 64, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, ref_ds.load_batch(idx))
    with Image.open(os.path.join(celeba_root, "celeba", "img_align_celeba", ds.filenames[3])) as im:
        pil = np.asarray(im.crop((15, 40, 163, 188)).resize((64, 64), Image.BILINEAR))
    np.testing.assert_array_equal(batch[1], pil)

    loader = data.DataLoader(ds, batch_size=2, seed=3)
    ref_loader = jdata.DataLoader(ref_ds, batch_size=2, seed=3)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        ref_loader.set_epoch(epoch)
        for (x, y), (rx, ry) in zip(loader, ref_loader, strict=True):
            assert x.dtype == np.float32 and y.shape == (2, 40) and y.dtype == np.float32
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)


@pytest.mark.parametrize("size,box,out", [
    ((218, 178), (40, 15, 148, 148), (64, 64)),  # celeba's transform
    ((37, 53), (3, 5, 30, 41), (17, 64)),         # a downscale and an upscale
    ((28, 28), (0, 0, 28, 28), (32, 32)),         # MNIST's resize
])
def test_crop_resize_bilinear_bit_equal_to_native(size, box, out):
    from vdiff_tpu import native
    from vdiff_tpu_torch.data import crop_resize_bilinear

    images = np.random.RandomState(sum(size)).randint(0, 256, (2, *size, 3), np.uint8)
    got = crop_resize_bilinear(images, *box, *out)
    np.testing.assert_array_equal(got, native.crop_resize_bilinear(images, *box, *out))


def test_label_stream_draws_attribute_rows_as_the_jax_cli(celeba_root):
    import generate as jax_cli
    from vdiff_tpu_torch.data import DATA_INFO
    from vdiff_tpu_torch.generate import make_label_stream

    info = DATA_INFO["celeba"]
    ref = jax_cli.make_label_stream(info, True, False, celeba_root, 1234)
    got = make_label_stream(info, True, False, 1234, celeba_root)
    for n in (4, 7):
        labels = got(n)
        assert labels.shape == (n, 40) and labels.dtype == np.float32
        np.testing.assert_array_equal(labels, np.asarray(ref(n)))
    np.testing.assert_array_equal(make_label_stream(info, True, True, 0, celeba_root)(3),
                                  np.zeros((3, 40), np.float32))


def _tiny_celeba_config(tmp_path):
    """celeba.json at the test width (hid 32, one block a level) with a short
    sampler and training run."""
    from vdiff_tpu_torch.factory import CONFIG_DIR

    with open(os.path.join(CONFIG_DIR, "celeba.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(hid_channels=32, num_res_blocks=1, embedding_dim=64, head_dim=32)
    cfg["train"].update(epochs=1, batch_size=2, warmup=2, image_intv=1, num_save_images=2,
                        ckpt_intv=1)
    cfg["diffusion"]["sample_timesteps"] = 2
    path = tmp_path / "tiny_celeba.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_celeba_train_then_generate_cli_on_cpu(celeba_root, tmp_path):
    """The train CLI on the tiny CelebA tree (3 steps of 2, the sample grid
    under tag rows of the set, ckpt_last), then the generate CLI from its
    checkpoint with tags drawn from the attribute table under --data-root,
    with CFG and with --uncond."""
    from vdiff_tpu_torch import generate, train

    cfg = _tiny_celeba_config(tmp_path)
    summary = train.main(["--config-path", cfg, "--device", "cpu", "--data_root", celeba_root,
                          "--exp-dir", str(tmp_path / "exps"), "--num-workers", "2"])
    assert summary["steps"] == 3 and np.isfinite(summary["loss"])
    assert os.path.exists(os.path.join(summary["image_dir"], "1.png"))
    ckpt = os.path.join(summary["ckpt_dir"], "ckpt_last.pt")
    sd = torch.load(ckpt, weights_only=True)["model"]
    assert sd["class_embed.weight"].shape == (64, 40)
    for extra in ([], ["--uncond"]):
        out = generate.main(["--config-path", cfg, "--ckpt-path", ckpt, "--device", "cpu",
                             "--data-root", celeba_root, "--save-dir", str(tmp_path / "gen"),
                             "--use-ema", "--use-ddim", "--sample-timesteps", "2",
                             "--batch-size", "2", "--total-size", "3", *extra])
        pngs = [f for f in os.listdir(out["save_dir"]) if f.endswith(".png")]
        assert out["images"] == len(pngs) == 3 and out["finite"]
        with Image.open(os.path.join(out["save_dir"], pngs[0])) as im:
            assert im.size == (64, 64)


@pytest.mark.parametrize("shape,out", [
    ((2, 28, 28, 3), (32, 32)),     # mnist upscale
    ((2, 148, 148, 3), (64, 64)),   # celeba downscale (antialias matters)
    ((1, 512, 333, 3), (100, 77)),  # non-square, large ratio
    ((2, 28, 28, 1), (32, 32)),     # grayscale
])
def test_resize_bilinear_bit_equal_to_native(shape, out):
    """The port's whole-image resize against the JAX package's
    ``native.resize_bilinear`` at tests/test_native.py's shapes, bit for bit."""
    from vdiff_tpu import native
    from vdiff_tpu_torch.data import _resize_batch_bilinear

    x = np.random.RandomState(2).randint(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(_resize_batch_bilinear(x, *out), native.resize_bilinear(x, *out))


@pytest.mark.parametrize("flips", [None, np.array([1, 0, 1, 0, 1], bool)])
def test_normalize_flip_bit_equal_to_native(flips):
    from vdiff_tpu import native
    from vdiff_tpu_torch.data import normalize_flip

    x = np.random.RandomState(1).randint(0, 256, (5, 4, 6, 3), np.uint8)
    got = normalize_flip(x, flips)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, native.normalize_flip(x, flips))


def test_toy_data_helpers_match_jax(tmp_path):
    """split_squeeze and infer_range equal the JAX package's; both
    save_scatterplot forms write a PNG."""
    from vdiff_tpu.utils import misc as jmisc
    from vdiff_tpu_torch.utils import misc

    pts = np.random.RandomState(4).randn(64, 2) * 3
    for a, b in zip(misc.split_squeeze(pts), jmisc.split_squeeze(pts)):
        np.testing.assert_array_equal(a, b)
    batches = [pts[:32], pts[32:] + 1.3]
    for precision in (1, 2, 5):
        got, ref = misc.infer_range(batches, precision), jmisc.infer_range(batches, precision)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    pytest.importorskip("matplotlib")
    misc.save_scatterplot(tmp_path / "a.png", pts, xlim=(-9, 9), ylim=(-9, 9))
    misc.save_scatterplot(tmp_path / "b.png", pts[:, 0])
    for name in ("a.png", "b.png"):
        with Image.open(tmp_path / name) as im:
            assert im.size == (600, 600)


@pytest.mark.parametrize("bins,value_range", [
    (8, None), ("auto", 4.0), ((5, 7), (-3, 5)), (6, ((-4, 4), (-2, 6))), ("auto", 3),
])
def test_histogram_helpers_match_jax(bins, value_range):
    """hist2d equals the JAX package's bit for bit on integer bins, "auto" and
    a pair of bins, with a range given as a number, a pair or a pair of pairs;
    discrete_klv2d of two such histograms (normalised, and raw counts with
    empty bins) within 1e-12."""
    from vdiff_tpu.ops import numerics as jnum
    from vdiff_tpu_torch.utils import misc

    rng = np.random.RandomState(7)
    pts, other = rng.randn(500, 2) * 2, rng.randn(500, 2) * 2 + 0.5
    h1, h2 = misc.hist2d(pts, bins, value_range), misc.hist2d(other, bins, value_range)
    for got, data in ((h1, pts), (h2, other)):
        ref = jnum.hist2d(data, bins, value_range)
        assert got.shape == ref.shape and got.sum() > 0
        assert np.array_equal(got, ref)
    for a, b in ((h1, h2), (h1 / h1.sum(), h2 / h2.sum())):
        got, ref = misc.discrete_klv2d(a, b), jnum.discrete_klv2d(a, b)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
