"""scripts/export_orbax_to_pt.py on the CPU: a small JAX train state saved by
the JAX package's own CheckpointManager becomes a reference-format .pt that
the port loads; the port's forward equals JAX's on it, its EMA weights
convert too, and the port's generate CLI samples from it."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

pytest_plugins = ["torch_limits"]
pytest.importorskip("orbax.checkpoint")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def exported(tmp_path):
    """(config path, .pt path, JAX params, JAX EMA params, the script's
    summary): cifar10_cond cut to tests/torch_parity.SMALL's widths, a
    TrainState at step 3 saved as ckpt_last, then exported."""
    from scripts.export_orbax_to_pt import main
    from vdiff_tpu.factory import CONFIG_DIR
    from vdiff_tpu.train_lib import CheckpointManager, TrainState, make_optimizer

    with open(os.path.join(CONFIG_DIR, "cifar10_cond.json")) as f:
        cfg = json.load(f)
    cfg["data"] = {"name": "cifar10"}
    cfg["model"].update(hid_channels=32, num_res_blocks=1, drop_rate=0.0)
    cfg_path = tmp_path / "tiny_cond.json"
    cfg_path.write_text(json.dumps(cfg))

    _, params = P.jax_unet()
    params = jax.tree.map(jnp.asarray, params)
    ema = jax.tree.map(lambda a: 0.5 * a, params)
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=params,
                       opt_state=make_optimizer(lr=1e-3).init(params), ema_params=ema)
    ckpt_dir = CheckpointManager(str(tmp_path / "ckpts")).save(state, epoch=1, epochs=1)
    out = str(tmp_path / "ckpt_last.pt")
    info = main(["--ckpt-dir", ckpt_dir, "--config-path", str(cfg_path), "--out", out])
    return str(cfg_path), out, params, ema, info


def test_export_loads_into_the_port_and_matches_jax(exported):
    """The exported weights load strictly into the UNet the port builds from
    the same config; its f32 forward equals JAX's within 1e-4 of the output's
    scale (test_torch_unet's bound); the EMA weights are JAX's EMA params
    converted, bit for bit."""
    from vdiff_tpu_torch.factory import build_unet, load_checkpoint_params, load_experiment_config
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict

    cfg_path, out, _, ema, info = exported
    assert info == {"out": out, "step": 3, "epoch": 1, "ema": True, "tensors": info["tensors"]}
    config, _ = load_experiment_config(cfg_path)
    sd, heads = load_checkpoint_params(out)
    assert "class_embed" in heads
    model = build_unet(config["model"], in_channels=3, model_out_type="eps", num_classes=10,
                       multitags=False)
    model.load_state_dict(sd, strict=True)
    x, t, y = P.inputs(B=2, seed=6)
    ref = P.jax_apply()(x, t, y)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, t, y))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    ema_sd, _ = load_checkpoint_params(out, use_ema=True)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, ema), config["model"])
    assert ema_sd.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(ema_sd[k].numpy(), v, err_msg=k)


def test_generate_cli_samples_from_the_export(exported, tmp_path):
    """``python -m vdiff_tpu_torch.generate --device cpu`` from the exported
    .pt with its EMA weights: 2 samples of 2 DDIM steps, finite PNGs."""
    from vdiff_tpu_torch.generate import main

    cfg_path, out, *_ = exported
    summary = main(["--config-path", cfg_path, "--ckpt-path", out, "--device", "cpu",
                    "--use-ema", "--use-ddim", "--sample-timesteps", "2", "--total-size", "2",
                    "--batch-size", "2", "--save-dir", str(tmp_path / "gen")])
    pngs = [f for f in os.listdir(summary["save_dir"]) if f.endswith(".png")]
    assert summary["images"] == len(pngs) == 2 and summary["finite"]


def test_help_says_the_optimizer_state_is_not_carried(capsys):
    from scripts.export_orbax_to_pt import main

    with pytest.raises(SystemExit):
        main(["--help"])
    assert "optimizer state is not carried" in " ".join(capsys.readouterr().out.split())
