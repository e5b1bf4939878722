"""The port's metrics vs the JAX package's on the CPU, same inputs: the FID
InceptionV3 (pool3 features and the IS head's probabilities) and VGG16's fc7
from one seeded release-format state dict each (``manifests.synth_state_dict``),
the bilinear resize, the inverse weight converters (bit for bit), FID, IS,
P&R and the k-NN radii on seeded features, and ``ImageFolder``.

Tolerances: the nets 1e-4 of max|ref| (f32 through ~95 convs, the two
libraries summing in other orders); the resize 1e-6; the numpy metrics
exactly, or 1e-5 where a distance passes through each library's f32
matmul."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import metric_state_dict  # noqa: E402

NET_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs six workers on a few
    cores, where torch's default of one thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _near(got, ref, rtol=NET_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def test_manifests_are_the_jax_packages():
    from vdiff_tpu.metrics import manifests as J
    from vdiff_tpu_torch.metrics import manifests as T

    assert T.fid_inception_manifest() == J.fid_inception_manifest()
    assert T.vgg16_manifest() == J.vgg16_manifest()
    head = dict(list(T.fid_inception_manifest().items())[:12])
    a, b = T.synth_state_dict(head, 3), J.synth_state_dict(head, 3)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("size", [(4, 32, 299), (2, 75, 75), (3, 32, 224), (1, 300, 224)])
def test_resize_is_jax_image_resize(size):
    """``resize_bilinear`` equals ``jax.image.resize(..., "bilinear",
    antialias=False)``: up to 299 and 224 from 32, the identity at 75, and a
    downscale."""
    from vdiff_tpu_torch.metrics.inception import resize_bilinear

    B, H, out = size
    x = np.random.RandomState(H).uniform(-1, 1, (B, H, H, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (B, out, out, 3), "bilinear", antialias=False)
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("res,resize", [(75, False), (32, True)])
def test_inception_features_and_is_head_match_jax(res, resize):
    from vdiff_tpu.metrics.inception import InceptionV3 as JaxInception
    from vdiff_tpu.metrics.inception import convert_fid_weights
    from vdiff_tpu_torch.metrics.inception import InceptionV3

    sd, tsd = metric_state_dict("inception")
    x = np.random.RandomState(res).uniform(-1, 1, (1, res, res, 3)).astype(np.float32)
    jm = JaxInception(output_blocks=(3,), resize_input=resize, include_head=True)
    feats, logits = jax.jit(jm.apply)(convert_fid_weights(sd, include_head=True), jnp.asarray(x))
    model = InceptionV3(output_blocks=(3,), resize_input=resize, include_head=True)
    model.load_state_dict(tsd, strict=True)
    with torch.no_grad():
        got_feats, got_logits = model(torch.from_numpy(x))
    _near(got_feats.numpy(), feats)
    _near(torch.softmax(got_logits, -1).numpy(), jax.nn.softmax(logits, -1))
    with torch.no_grad():  # the features depend on the image
        other = model(torch.from_numpy(x[:, ::-1].copy()))[0]
    assert (other - got_feats).abs().max() > 1e2 * NET_RTOL * got_feats.abs().max()


def test_vgg_fc7_matches_jax():
    from vdiff_tpu.metrics.vgg import VGG16Features as JaxVGG
    from vdiff_tpu.metrics.vgg import _IMAGENET_MEAN_255, convert_vgg_weights
    from vdiff_tpu_torch.metrics.vgg import VGG16Features, load_vgg_state_dict

    sd, tsd = metric_state_dict("vgg16")
    x = np.random.RandomState(2).randint(0, 256, (1, 32, 32, 3)).astype(np.float32)
    xr = jax.image.resize(jnp.asarray(x), (1, 224, 224, 3), "bilinear", antialias=False)
    ref = jax.jit(JaxVGG().apply)(convert_vgg_weights(sd), xr - jnp.asarray(_IMAGENET_MEAN_255))
    model = VGG16Features()
    load_vgg_state_dict(model, tsd)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _near(got.numpy(), ref)
    with pytest.raises(KeyError, match="unexpected vgg16"):
        load_vgg_state_dict(model, {**tsd, "features.1.weight": torch.zeros(1)})


def test_inverse_converters_round_trip_bit_for_bit():
    """synth_state_dict → the JAX package's converter → the port's inverse →
    the same dict (VGG's fc8, which the converter drops, aside)."""
    from vdiff_tpu.metrics.inception import convert_fid_weights
    from vdiff_tpu.metrics.vgg import convert_vgg_weights
    from vdiff_tpu_torch.metrics.inception import inception_state_dict_from_flax
    from vdiff_tpu_torch.metrics.vgg import vgg_state_dict_from_flax

    for net, convert, inverse, dropped in (
            ("inception", lambda sd: convert_fid_weights(sd, include_head=True),
             inception_state_dict_from_flax, ()),
            ("vgg16", convert_vgg_weights, vgg_state_dict_from_flax,
             ("classifier.6.weight", "classifier.6.bias"))):
        sd, _ = metric_state_dict(net)
        back = inverse(convert(sd))
        assert set(back) == set(sd) - set(dropped)
        for k, v in back.items():
            assert v.dtype == torch.from_numpy(np.asarray(sd[k])).dtype, k
            assert np.array_equal(v.numpy(), sd[k]), k


def test_fid_and_is_statistics_match_jax():
    """Streaming FID statistics, the Fréchet distance and the streaming IS
    over the same seeded features: the same numpy code, so the same numbers."""
    from vdiff_tpu.metrics import fid as JF
    from vdiff_tpu.metrics import inception_score as JI
    from vdiff_tpu_torch.metrics import fid as F
    from vdiff_tpu_torch.metrics import inception_score as I

    rng = np.random.RandomState(0)
    feats = [rng.randn(n, 16) * 0.3 + 0.1 for n in (7, 5, 9)]
    probs = [rng.dirichlet(np.ones(12) * 0.3, n) for n in (7, 5, 9)]
    fn = lambda x: x
    stats = []
    for mod_f, mod_i in ((JF, JI), (F, I)):
        st = mod_f.InceptionStatistics(feature_fn=fn, activation_dim=16)
        iss = mod_i.InceptionScoreStatistics(prob_fn=fn, splits=3, num_classes=12)
        for f, p in zip(feats, probs):
            st(f)
            iss(p)
        m, c = st.get_statistics()
        stats.append((m, c, mod_f.calc_fd(m, c, m + 0.2, c * 1.5), iss.get_statistics(),
                      mod_i.calc_is(np.concatenate(probs), 3)))
    (jm, jc, jfd, jis, jcis), (m, c, fd, is_, cis) = stats
    assert np.array_equal(m, jm) and np.array_equal(c, jc)
    assert fd == jfd and is_ == jis and cis == jcis
    assert F.calc_fd(m, c, m, c) == pytest.approx(0.0, abs=1e-9)


def test_precision_recall_and_kth_radii_match_jax():
    from vdiff_tpu.metrics import precision_recall as JP
    from vdiff_tpu_torch.metrics import precision_recall as P

    rng = np.random.RandomState(1)
    real = (rng.randn(40, 24)).astype(np.float16)
    gen = (rng.randn(30, 24) * 1.2 + 0.3).astype(np.float16)
    kw = dict(nhood_size=3, row_batch_size=16, col_batch_size=12)
    for feats in (real, gen):
        np.testing.assert_allclose(
            P._kth_radii(feats.astype(np.float32), 3, 16, 12, device="cpu"),
            JP._kth_radii(feats.astype(np.float32), 3, 16, 12), rtol=1e-5)
    jr, jg = (JP.ManifoldBuilder(features=f, **kw).manifold for f in (real, gen))
    tr, tg = (P.ManifoldBuilder(features=f, device="cpu", **kw).manifold for f in (real, gen))
    np.testing.assert_allclose(tr.kth, jr.kth, rtol=1e-5)
    assert P.calc_pr(tg, tr, 16, 12, device="cpu") == JP.calc_pr(jg, jr, 16, 12)
    assert P.calc_pr(tr, tr, 16, 12, device="cpu") == (1.0, 1.0)
    np.testing.assert_allclose(P.compute_distance(gen, real, 16, 12, device="cpu"),
                               JP.compute_distance(gen, real, 16, 12), rtol=1e-5, atol=1e-5)


def test_manifold_builder_subsamples_as_jax():
    """Over max_sample_size the same RandomState(1234) subsample, features
    stored as float16."""
    from vdiff_tpu.metrics import precision_recall as JP
    from vdiff_tpu_torch.metrics import precision_recall as P

    images = np.random.RandomState(2).randint(0, 256, (20, 4, 4, 3)).astype(np.uint8)
    fn = lambda x: np.asarray(x, np.float32).reshape(len(x), -1) / 255.0
    kw = dict(feature_fn=fn, extr_batch_size=4, max_sample_size=9, nhood_size=2)
    got = P.ManifoldBuilder(data=images, device="cpu", **kw)
    ref = JP.ManifoldBuilder(data=images, **kw)
    assert got.features.dtype == np.float16
    assert np.array_equal(got.features, ref.features)
    np.testing.assert_allclose(got.kth, ref.kth, rtol=1e-5)


def test_image_folder_matches_jax(tmp_path):
    from PIL import Image

    from vdiff_tpu.data import ImageFolder as JaxImageFolder
    from vdiff_tpu_torch.data import ImageFolder

    rng = np.random.RandomState(3)
    for i, ext in enumerate(["png", "PNG", "jpg", "bmp"]):
        Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(
            tmp_path / f"{i}.{ext}")
    Image.fromarray(rng.randint(0, 256, (8, 8)).astype(np.uint8)).save(tmp_path / "grey.png")
    (tmp_path / "notes.txt").write_text("not an image")
    got, ref = ImageFolder(str(tmp_path)), JaxImageFolder(str(tmp_path))
    assert len(got) == len(ref) == 5 and got.img_list == ref.img_list
    idx = np.array([4, 0, 2])
    batch = got.load_batch(idx)
    assert batch.dtype == np.uint8 and batch.shape == (3, 8, 8, 3)
    assert np.array_equal(batch, ref.load_batch(idx))


def test_apply_batched_and_the_dp_refusal():
    from vdiff_tpu_torch.metrics.device_apply import apply_batched, resolve_eval_mesh

    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(5, 2, 3)
    out = apply_batched(lambda b: b.sum(dim=(1, 2))[:, None], x, 2, device="cpu")
    np.testing.assert_array_equal(out, x.sum(axis=(1, 2))[:, None])
    assert apply_batched(lambda b: b.sum(dim=(1, 2))[:, None], x[:0], 2, "cpu").shape == (0, 1)
    with pytest.raises(ValueError, match="item shape"):
        apply_batched(lambda b: b, np.zeros((0,)), 2, "cpu")
    assert resolve_eval_mesh(False, "cpu") == (None, torch.device("cpu"))
    # --dp runs under torchrun (tests/test_torch_parallel.py runs it there)
    with pytest.raises(SystemExit, match="--dp runs one process per device under torchrun"):
        resolve_eval_mesh(True, "cpu")
