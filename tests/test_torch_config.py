"""Twins of tests/test_config.py against the port's copy of the config
system (vdiff_tpu_torch/utils/config.py), and every shipped experiment
config merged by the port as the JAX package merges it."""

import copy
import json
import os
import types

import pytest

from vdiff_tpu_torch.utils.config import dict2str, fill_with_defaults, update_config

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "vdiff_tpu",
                          "configs")
SHIPPED = sorted(f for f in os.listdir(CONFIG_DIR) if f.endswith(".json") and f != "defaults.json")


def test_fill_with_defaults_reference_example():
    config = {"a": None, "b": {"c": 1, "d": None}}
    defaults = {"a": 2, "b": {"c": 3, "d": 4, "e": 5}, "f": 6}
    fill_with_defaults(config, defaults)
    assert config == {"a": 2, "b": {"c": 1, "d": 4, "e": 5}, "f": 6}


def test_fill_with_defaults_null_section():
    """An explicit JSON null for a whole section counts as unset."""
    config = {"train": None}
    defaults = {"train": {"lr": 1e-4, "epochs": 10}}
    fill_with_defaults(config, defaults)
    assert config == {"train": {"lr": 1e-4, "epochs": 10}}


def test_update_config_cli_precedence():
    old = {"lr": 1e-4}
    args = types.SimpleNamespace(lr=3e-4)
    assert update_config("lr", old_config=old, new_config=args) == 3e-4
    assert old["lr"] == 3e-4


def test_update_config_none_falls_back():
    old = {"lr": 1e-4}
    args = types.SimpleNamespace(lr=None)
    assert update_config("lr", old_config=old, new_config=args) == 1e-4


def test_update_config_or_flag_rule():
    """A False store_true CLI flag falls back to the config value."""
    old = {"use_ema": True}
    args = types.SimpleNamespace(use_ema=False)
    assert update_config("use_ema", old_config=old, new_config=args, logical_op="OR") is True
    args = types.SimpleNamespace(use_ema=True)
    old = {"use_ema": False}
    assert update_config("use_ema", old_config=old, new_config=args, logical_op="OR") is True


def test_update_config_renamed_key():
    old = {"root": "~/datasets"}
    args = types.SimpleNamespace(data_root="/tmp/x")
    assert update_config("root", "data_root", old_config=old, new_config=args) == "/tmp/x"


def test_dict2str():
    assert dict2str({"a": 1, "b": [2, 3], "c": 0.001}) == "a_1_b_2_3_c_1e-03"


def test_shipped_configs_parse_and_merge():
    with open(os.path.join(CONFIG_DIR, "defaults.json")) as f:
        defaults = json.load(f)
    assert "epochs" in defaults["train"]
    for name in ("cifar10_uncond.json", "cifar10_cond.json", "celeba.json", "mnist.json"):
        with open(os.path.join(CONFIG_DIR, name)) as f:
            cfg = json.load(f)
        fill_with_defaults(cfg, defaults)
        assert cfg["diffusion"]["logsnr_schedule"] in {"linear", "sigmoid", "cosine", "legacy"}
        assert cfg["train"]["batch_size"] > 0


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_merges_as_jax_merges_it(name):
    """The port's deep merge of the experiment over defaults.json equals the
    JAX package's; so do the CLIs' loaders, but for the one rule the port
    adds: an experiment naming head_dim and not num_heads keeps num_heads
    unset (factory.load_experiment_config)."""
    pytest.importorskip("jax")
    from vdiff_tpu.factory import load_experiment_config as jax_load
    from vdiff_tpu.utils.config import fill_with_defaults as jax_fill
    from vdiff_tpu_torch.factory import load_experiment_config

    path = os.path.join(CONFIG_DIR, name)
    with open(path) as f:
        cfg = json.load(f)
    with open(os.path.join(CONFIG_DIR, "defaults.json")) as f:
        defaults = json.load(f)
    ref, own_model = copy.deepcopy(cfg), dict(cfg.get("model", {}))
    fill_with_defaults(cfg, defaults)
    jax_fill(ref, copy.deepcopy(defaults))
    assert cfg == ref
    got, got_name = load_experiment_config(path)
    want, want_name = jax_load(path)
    assert got_name == want_name
    if "head_dim" in own_model and "num_heads" not in own_model:
        assert got["model"]["num_heads"] is None
        got["model"]["num_heads"] = want["model"]["num_heads"]
    assert got == want
