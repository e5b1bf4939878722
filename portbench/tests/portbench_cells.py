"""Tiny versions of the benchmark's cells for the CPU tests: the cell's own
files, with the widths, depth, batch and steps cut so that a test runs in
seconds. Only the tests cut anything; the benchmark's runs never do."""

import os

import pytest
import torch

from portbench.core.spec import load_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("cifar10_cond.sample_cfg_b128", "cifar10_cond.train_f32_b128",
         "celeba.train_f32_b48", "celeba.sample_cfg_b32")


def tiny_cell(name: str, batch: int = 4, steps: int = 3):
    cell = load_cell(name, ROOT)
    config = cell.config
    config["data"]["resolution"] = 16
    config["model"].update(hid_channels=32, ch_multipliers=[1, 2], num_res_blocks=1,
                           apply_attn=[False, True])
    if config["model"].get("embedding_dim"):
        config["model"]["embedding_dim"] = 64
    if config["model"].get("head_dim"):
        config["model"]["head_dim"] = 32
    cell.traffic["batch"] = batch
    if cell.traffic["job"] == "sample":
        cell.traffic["steps"] = steps
    cell.limits["compare"].update(block=2, rows=min(cell.limits["compare"].get("rows", 4), 4))
    return cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
