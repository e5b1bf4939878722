"""Port weight bridge, import hygiene, checkpoint loading and the sampling CLI
(vdiff_tpu_torch.models.convert, factory, generate) on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "vdiff_tpu_torch", "vdiff_tpu_torch.kernels", "vdiff_tpu_torch.ops.attention",
    "vdiff_tpu_torch.ops.groupnorm", "vdiff_tpu_torch.ops.conv3x3", "vdiff_tpu_torch.ops.numerics",
    "vdiff_tpu_torch.models.layers", "vdiff_tpu_torch.models.remat", "vdiff_tpu_torch.models.unet",
    "vdiff_tpu_torch.models.convert", "vdiff_tpu_torch.diffusion", "vdiff_tpu_torch.factory",
    "vdiff_tpu_torch.generate", "vdiff_tpu_torch.utils.config", "vdiff_tpu_torch.data",
    "vdiff_tpu_torch.utils.misc", "vdiff_tpu_torch.train_lib", "vdiff_tpu_torch.train",
    "vdiff_tpu_torch.eval", "vdiff_tpu_torch.metrics", "vdiff_tpu_torch.metrics.fid",
    "vdiff_tpu_torch.metrics.inception", "vdiff_tpu_torch.metrics.vgg",
    "vdiff_tpu_torch.metrics.inception_score", "vdiff_tpu_torch.metrics.precision_recall",
    "vdiff_tpu_torch.metrics.device_apply", "vdiff_tpu_torch.metrics.manifests",
    "vdiff_tpu_torch.parallel", "vdiff_tpu_torch.parallel.mesh", "vdiff_tpu_torch.parallel.fsdp",
    "vdiff_tpu_torch.parallel.dryrun", "vdiff_tpu_torch.parallel.tp",
    "vdiff_tpu_torch.parallel.spatial",
]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_flax_to_port_to_flax_round_trip_is_exact():
    from vdiff_tpu.models.convert import torch_unet_to_flax

    jm, params = P.jax_unet()
    port = P.port_unet()  # strict load of flax_params_to_state_dict(params)
    back = _flat(torch_unet_to_flax(port.state_dict(), jm))
    ref = _flat(jax.tree.map(np.asarray, params))
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_port_to_flax_to_port_round_trip_is_exact():
    from vdiff_tpu.models.convert import torch_unet_to_flax
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    jm, _ = P.jax_unet(num_res_blocks=2)
    cfg = dict(P.SMALL, num_res_blocks=2)
    sd = UNet(**cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    back = flax_params_to_state_dict(torch_unet_to_flax(sd, jm), cfg)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has jax loaded by conftest). tqdm is
    not checked: torch itself imports it where it is installed."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'vdiff_tpu', 'PIL') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_use_no_library_attention():
    """The port never calls library attention, torch.compile or JAX.
    chip_smoke.py times scaled_dot_product_attention as a yardstick
    (``library_ms``) inside its ``_sdpa`` helper, and nowhere else."""
    import ast

    smoke = os.path.join(REPO, "chip_smoke.py")
    paths = [smoke]
    for root, _, files in os.walk(os.path.join(REPO, "vdiff_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    for path in paths:
        with open(path) as f:
            text = f.read()
        for banned in ("torch.compile", "import jax"):
            assert banned not in text, (path, banned)
        if path != smoke:
            assert "scaled_dot_product_attention" not in text, path
    with open(smoke) as f:
        text = f.read()
    (helper,) = [n for n in ast.parse(text).body if isinstance(n, ast.FunctionDef) and n.name == "_sdpa"]
    lines = [i for i, line in enumerate(text.splitlines(), 1) if "scaled_dot_product_attention" in line]
    assert lines and all(helper.lineno <= i <= helper.end_lineno for i in lines), lines


def test_png_encoder_round_trips_through_pil():
    Image = pytest.importorskip("PIL.Image")
    from io import BytesIO

    from vdiff_tpu_torch.generate import encode_png

    rng = np.random.RandomState(0)
    for img in (rng.randint(0, 256, (5, 7, 3), dtype=np.uint8),
                rng.randint(0, 256, (4, 6, 1), dtype=np.uint8)):
        with Image.open(BytesIO(encode_png(img))) as im:
            np.testing.assert_array_equal(np.asarray(im), img.squeeze(-1) if img.shape[-1] == 1 else img)


def test_label_stream_matches_jax_cli():
    import generate as jax_cli
    from vdiff_tpu_torch.data import DATA_INFO
    from vdiff_tpu_torch.generate import make_label_stream

    info = DATA_INFO["cifar10"]
    ref = jax_cli.make_label_stream(info, True, False, "", 1234)
    got = make_label_stream(info, True, False, 1234)
    for n in (4, 7):
        np.testing.assert_array_equal(got(n), np.asarray(ref(n)))
    assert make_label_stream(info, False, False, 0)(3) is None
    np.testing.assert_array_equal(make_label_stream(info, True, True, 0)(3), np.zeros(3))


def test_checkpoint_loading(tmp_path):
    from vdiff_tpu_torch.factory import load_checkpoint_params

    sd = {"module.in_conv.weight": torch.ones(2), "class_embed.1.bias": torch.zeros(1)}
    ema = {"in_conv.weight": torch.full((2,), 3.0)}
    path = tmp_path / "m.pt"
    torch.save({"model": sd, "ema": {"shadow": ema}}, path)
    got, heads = load_checkpoint_params(str(path))
    assert set(got) == {"in_conv.weight", "class_embed.1.bias"} and heads == {"in_conv", "class_embed"}
    got, heads = load_checkpoint_params(str(path), use_ema=True)
    assert float(got["in_conv.weight"][0]) == 3.0 and heads == {"in_conv"}
    with pytest.raises(NotImplementedError, match="Orbax.*scripts/export_orbax_to_pt.py"):
        load_checkpoint_params(str(tmp_path))


def _tiny_setup(tmp_path):
    """A cifar10_cond-style config at the test width, and a .pt of the small
    UNet's perturbed weights."""
    from vdiff_tpu_torch.factory import CONFIG_DIR

    with open(os.path.join(CONFIG_DIR, "cifar10_cond.json")) as f:
        cfg = json.load(f)
    cfg["data"] = {"name": "cifar10"}
    cfg["model"].update(hid_channels=32, num_res_blocks=1)
    cfg_path = tmp_path / "tiny_cond.json"
    cfg_path.write_text(json.dumps(cfg))
    sd = P.port_unet().state_dict()
    ckpt = tmp_path / "tiny.pt"
    torch.save({"model": sd, "ema": {"shadow": sd}}, ckpt)
    return str(cfg_path), str(ckpt)


@pytest.mark.parametrize("w_guide", ["0", "0.1"])
def test_generate_cli_on_cpu(tmp_path, w_guide):
    from vdiff_tpu_torch.generate import main

    cfg, ckpt = _tiny_setup(tmp_path)
    summary = main(["--config-path", cfg, "--ckpt-path", ckpt, "--save-dir", str(tmp_path / "out"),
                    "--device", "cpu", "--use-ema", "--use-ddim", "--sample-timesteps", "3",
                    "--w-guide", w_guide, "--batch-size", "2", "--total-size", "3"])
    pngs = [f for f in os.listdir(summary["save_dir"]) if f.endswith(".png")]
    assert summary["images"] == len(pngs) == 3 and summary["finite"]


@pytest.mark.parametrize("flags", [["--dp", "--progressive"], ["--tp"], ["--spatial-shard"],
                                   ["--progressive", "--pred-freq", "0"],
                                   ["--use-ddim", "--eta", "1.5"], ["--eta", "0.5"]])
def test_generate_cli_refuses_what_is_not_ported(tmp_path, flags):
    """Flag combinations the CLI refuses (--tp and --spatial-shard outside
    torchrun)."""
    from vdiff_tpu_torch.generate import main

    with pytest.raises(SystemExit):
        main(["--config-path", "x.json", "--ckpt-path", "x.pt", "--device", "cpu", *flags])


def test_generate_cli_refuses_missing_cuda(monkeypatch):
    from vdiff_tpu_torch.generate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        main(["--config-path", "x.json", "--ckpt-path", "x.pt"])


def test_verbatim_copies_match_the_jax_package():
    """utils/config.py and DATA_INFO are copies (the JAX package's modules
    import jax); they must not drift."""
    from vdiff_tpu.data import DATA_INFO as JAX_INFO
    from vdiff_tpu_torch.data import DATA_INFO

    with open(os.path.join(REPO, "vdiff_tpu", "utils", "config.py")) as a, \
            open(os.path.join(REPO, "vdiff_tpu_torch", "utils", "config.py")) as b:
        assert a.read() == b.read()
    assert DATA_INFO == JAX_INFO


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "vdiff_tpu", "configs"))))
def test_config_copies_match_the_jax_package(name):
    """The port reads its own copies of the experiment configs; each is the
    JAX package's file byte for byte, and the port has no other."""
    with open(os.path.join(REPO, "vdiff_tpu", "configs", name), "rb") as a, \
            open(os.path.join(REPO, "vdiff_tpu_torch", "configs", name), "rb") as b:
        assert a.read() == b.read()
    assert (sorted(os.listdir(os.path.join(REPO, "vdiff_tpu_torch", "configs")))
            == sorted(os.listdir(os.path.join(REPO, "vdiff_tpu", "configs"))))
