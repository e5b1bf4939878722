"""The yardstick's arithmetic on known shapes: the model's operations against
a count by hand, the attention calls' least times, and the trace's union of
intervals and idle gaps."""

import math

import pytest

from portbench.core import roofline
from portbench.core.spec import model_cfg
from portbench.core.trace import Trace
from portbench.reference.unet import blocks, heads, param_shapes
from portbench.core.spec import load_cell
from portbench_cells import CELLS, ROOT, tiny_cell


def _by_hand(cfg, batch):
    """2·(weight entries)·(positions it is applied at) for every convolution
    and projection, plus 4·T²·C for each attention's two products."""
    shapes = param_shapes(cfg)
    res, r0 = {}, cfg["resolution"]
    for key in ("time_embed.0", "time_embed.2", "class_embed", "class_embed.1"):
        res[key] = 1
    res["in_conv"] = res["out_conv.2"] = r0 * r0
    r, attn = r0, 0.0
    for key, _, cout, resampling, has_attn in blocks(cfg):
        r = r // 2 if resampling == "down" else r * 2 if resampling == "up" else r
        rb = f"{key}.0" if has_attn else key
        for part in ("conv1", "conv2", "skip"):
            res[f"{rb}.{part}"] = r * r
        res[f"{rb}.fc"] = 1
        for a in ([f"{key}.1"] if has_attn else []) + (["middle.1"] if key == "middle.0" else []):
            res[f"{a}.proj_in"] = res[f"{a}.proj_out"] = r * r
            attn += 4.0 * (r * r) ** 2 * cout
    total = sum(2.0 * math.prod(s) * res[k.rsplit(".", 1)[0]] for k, s in shapes.items()
                if len(s) >= 2)
    return batch * (total + attn)


@pytest.mark.parametrize("name", CELLS)
def test_model_flops_match_a_count_by_hand(name):
    cfg = model_cfg(tiny_cell(name).config)
    assert roofline.model_flops(cfg, 3, train=False) == pytest.approx(_by_hand(cfg, 3), rel=1e-12)


@pytest.mark.parametrize("name", ["cifar10_cond.sample_cfg_b128", "celeba.sample_cfg_b32"])
def test_full_size_counts(name):
    """The published widths: one forward's operations a sample (cifar10_cond
    ~37.5 GFLOP), and a train step about three forwards."""
    cfg = model_cfg(load_cell(name, ROOT).config)
    fwd = roofline.model_flops(cfg, 1, train=False)
    assert fwd == pytest.approx(_by_hand(cfg, 1), rel=1e-12)
    if name.startswith("cifar10"):
        assert 30e9 < fwd < 45e9
    train = roofline.model_flops(cfg, 1, train=True)
    assert 2.5 * fwd < train < 3.1 * fwd


def test_attention_shapes_and_least_time():
    cfg = model_cfg(load_cell("cifar10_cond.sample_cfg_b128", ROOT).config)
    shapes = roofline.attention_shapes(cfg)
    assert sorted(t for t, _, _ in shapes) == [64] * 9 + [256] * 8 + [1024]
    assert all(n == 1 and c == 256 for _, n, c in shapes)
    # with no attention but the middle one: one call at T=64, C=256; batch 1 in
    # bf16 is 4·T²·C ops at 989.4 TFLOP/s against 4·T·C·2 bytes at 3.35 TB/s
    cfg1 = dict(cfg, resolution=32, apply_attn=[False, False, False])
    base = roofline.attention_least_s(cfg1, 1, "bfloat16", False)
    ops = 4.0 * 64 * 64 * 256
    assert base == pytest.approx(max(ops / 989.4e12, 4 * 64 * 256 * 2 / 3.35e12))
    both = roofline.attention_least_s(cfg1, 2, "float32", True)
    assert both == pytest.approx(2 * (max(ops / 494.7e12, 4 * 64 * 256 * 4 / 3.35e12)
                                      + max(2 * ops / 494.7e12, 7 * 64 * 256 * 4 / 3.35e12)))
    celeba = model_cfg(load_cell("celeba.train_f32_b48", ROOT).config)
    assert (4096, 6, 64) in roofline.attention_shapes(celeba)
    assert heads(celeba, 768) == 12


def test_trace_union_and_gaps():
    tr = Trace(0, 100)
    tr.device = [("a", 10, 20), ("b", 20, 20), ("c", 60, 10), ("d", 95, 20)]
    tr.host = [("outer", 0, 100), ("sync", 40, 60), ("launch", 70, 95)]
    assert tr.merged() == [(10, 40), (60, 70), (95, 100)]
    assert tr.busy_s() == pytest.approx(45e-9)
    assert tr.device_ops(2) == [["a", 20e-9], ["b", 20e-9]]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["launch", 25e-9] and gaps[1] == ["sync", 20e-9]
    assert gaps[2] == ["outer", 10e-9]
    assert tr.kernel_count() == 4
