"""The port's spans (``vdiff_tpu_torch/utils/profiling.py::span``) on the CPU:
off without a profiler, nested ranges in the profiler's events with one on,
the calls a tiny UNet's train step and eager sampler record, the train step
bit for bit with the profiler on and off, and the device time given to the
innermost span by launch correlation. One test, marked ``chip``, needs a
CUDA card: ``python -m pytest --noconftest tests/test_torch_spans.py -m chip``."""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vdiff_tpu_torch.factory import build_diffusion, build_unet
from vdiff_tpu_torch.train_lib import Optimizer, make_train_step
from vdiff_tpu_torch.utils.profiling import attribute, span, span_totals

pytest_plugins = ["torch_limits"]

GN, CONV, ATTN = "vdiff.unet.gn_chain", "vdiff.unet.conv", "vdiff.unet.attention"
OPT, CAPTURE = "vdiff.train.optimizer", "vdiff.sample.capture"
MODEL = {"hid_channels": 32, "ch_multipliers": [1, 1], "num_res_blocks": 1,
         "apply_attn": [False, True], "drop_rate": 0.1, "num_heads": 1}
DIFFUSION = {"logsnr_min": -20.0, "logsnr_max": 20.0, "logsnr_schedule": "cosine",
             "train_timesteps": 0, "sample_timesteps": 3, "model_out_type": "v",
             "model_var_type": "fixed_large", "reweight_type": "snr_1plus", "loss_type": "mse"}


def _unet(device="cpu"):
    return build_unet(MODEL, in_channels=3, model_out_type="v", num_classes=10, multitags=False,
                      generator=torch.Generator().manual_seed(0)).to(device)


def _calls(model):
    """Forward calls of the GroupNorms and attention blocks, counted by hooks."""
    from vdiff_tpu_torch.models.unet import AttentionBlock, GroupNorm32

    calls = {GN: 0, ATTN: 0}

    def hook(key):
        def count(*_):
            calls[key] += 1
        return count

    for m in model.modules():
        if isinstance(m, GroupNorm32):
            m.register_forward_hook(hook(GN))
        elif isinstance(m, AttentionBlock):
            m.register_forward_hook(hook(ATTN))
    return calls


def _convs(model):
    """The convs a forward runs, each once: every ``Conv2d`` but the attention
    blocks' projections, which run as token matmuls outside the conv span."""
    return sum(isinstance(m, torch.nn.Conv2d) and name.rsplit(".", 1)[-1] not in
               ("proj_in", "proj_out") for name, m in model.named_modules())


def _train_once(profiled: bool):
    """One train step of the tiny UNet (dropout, CFG, clip, AdamW, EMA) with
    or without the profiler: (loss, params, ema, span totals or None, hook
    counts)."""
    model = _unet()
    ema = copy.deepcopy(model).requires_grad_(False)
    calls = _calls(model)
    opt = Optimizer(model.parameters(), lr=1e-3, warmup=2, grad_norm=1.0, weight_decay=1e-3)
    diffusion, timesteps = build_diffusion(DIFFUSION, w_guide=0.1, p_uncond=0.1)
    step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True, ema_decay=0.9,
                           ema_model=ema)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1
    y = torch.tensor([1, 7])
    totals = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            loss = step(x, y, 5, 0)
        totals = span_totals(prof)
    else:
        loss = step(x, y, 5, 0)
    return (loss, [p.detach().clone() for p in model.parameters()],
            [p.clone() for p in ema.parameters()], totals, calls)


@pytest.fixture(scope="module")
def train_runs():
    return _train_once(False), _train_once(True)


def test_span_without_a_profiler_makes_no_range_and_no_event(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("called while no profiler records")

    from vdiff_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with span("vdiff.test.off") as region:
        assert region is None
    assert span("vdiff.test.a") is span("vdiff.test.b")  # one shared no-op
    model = _unet().eval()
    with torch.no_grad():
        model(torch.zeros(2, 16, 16, 3), torch.zeros(2), torch.tensor([1, 0]))


def test_spans_nest_in_the_profiler_events_and_are_counted():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("vdiff.test.outer"):
            with span("vdiff.test.inner"):
                torch.randn(16, 16) @ torch.randn(16, 16)
            with span("vdiff.test.inner"):
                pass
        with span("other.region"):  # not the program's: no vdiff. prefix
            pass
    events = {e.name: e for e in prof.events() if e.name.startswith("vdiff.test.")}
    outer, inner = events["vdiff.test.outer"], events["vdiff.test.inner"]
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "vdiff.test.outer"
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert span_totals(prof) == {"vdiff.test.outer": {"count": 1, "device_ms": 0.0},
                                 "vdiff.test.inner": {"count": 2, "device_ms": 0.0}}


def test_a_train_step_records_each_layer_forward_and_backward(train_runs):
    (*_, off_totals, _), (*_, totals, calls) = train_runs
    assert off_totals is None
    assert calls[GN] > 0 and calls[ATTN] > 0
    assert totals[GN]["count"] == 2 * calls[GN]
    assert totals[ATTN]["count"] == 2 * calls[ATTN]
    assert totals[OPT]["count"] == 1
    assert totals[CONV]["count"] == _convs(_unet())
    assert set(totals) == {GN, CONV, ATTN, OPT}
    assert all(t["device_ms"] == 0.0 for t in totals.values())  # no device on the CPU


def test_a_train_step_is_bit_identical_with_the_profiler_on_and_off(train_runs):
    (loss0, params0, ema0, *_), (loss1, params1, ema1, *_) = train_runs
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
    assert all(torch.equal(a, b) for a, b in zip(ema0, ema1))


def test_an_eager_p_sample_records_the_unet_spans_every_step():
    model = _unet().eval()
    calls = _calls(model)
    diffusion, _ = build_diffusion(DIFFUSION, w_guide=0.1, sample_timesteps=3,
                                   continuous_gate=False)
    x_T = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(2))
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        diffusion.p_sample(model, x_T, label=torch.tensor([1, 4]), use_ddim=True, stats=stats)
    totals = span_totals(prof)
    assert stats["eager_steps"] == 3 and calls[GN] % 3 == 0 and calls[ATTN] % 3 == 0
    assert totals[GN]["count"] == calls[GN] and totals[ATTN]["count"] == calls[ATTN]
    assert totals[CONV]["count"] == 3 * _convs(model)
    assert set(totals) == {GN, CONV, ATTN}


# spans (thread, start, end, name) and launches (thread, host time, device ns)
_OUTER, _INNER = (1, 100, 500, "a"), (1, 200, 300, "b")


@pytest.mark.parametrize("spans,launches,want", [
    # inside the inner span, inside the outer only, and outside both
    ([_OUTER, _INNER], [(1, 250, 7), (1, 150, 5), (1, 450, 1), (1, 600, 100)], {"a": 6, "b": 7}),
    # a launch at a span's first instant (the range itself launched it) and
    # at its last; an inner span that starts with its outer one
    ([_OUTER, (1, 100, 200, "b")], [(1, 100, 3), (1, 200, 4), (1, 500, 9)], {"b": 7, "a": 9}),
    # siblings after a long closed span: the later launch finds the outer span
    ([_OUTER, _INNER, (1, 310, 320, "c")], [(1, 315, 2), (1, 330, 8)], {"c": 2, "a": 8}),
    # the backward runs on its own thread: a launch counts for its thread's span
    ([_OUTER, (2, 120, 480, "c")], [(2, 150, 6), (1, 150, 4), (3, 150, 1)], {"c": 6, "a": 4}),
    ([], [(1, 10, 5)], {}),
], ids=["nested", "edges", "siblings", "threads", "no-spans"])
def test_device_time_goes_to_the_innermost_span_of_the_launching_thread(spans, launches, want):
    assert attribute(spans, launches) == want


@pytest.mark.chip
def test_a_graph_p_sample_times_its_eager_step_and_not_its_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = _unet("cuda").eval()
    diffusion, _ = build_diffusion(dict(DIFFUSION, sample_timesteps=4), w_guide=0.1,
                                   continuous_gate=False)
    x_T = torch.randn(2, 16, 16, 3, device="cuda")
    y = torch.tensor([1, 4], device="cuda")
    diffusion.p_sample(model, x_T, label=y, use_ddim=True)  # builds the kernels
    stats = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            diffusion.p_sample(model, x_T, label=y, use_ddim=True, stats=stats)
        torch.cuda.synchronize()
    totals = span_totals(prof)
    assert stats["eager_steps"] == 2 and stats["captures"] == 2 and stats["replays"] == 6
    # the captured step's kernels run only in the replays, outside every span;
    # the capture holds only the graph's own set-up on the device
    unet_ms = sum(totals[name]["device_ms"] for name in (GN, CONV, ATTN))
    assert totals[CAPTURE]["count"] == 2 and totals[CAPTURE]["device_ms"] < 0.02 * unet_ms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eager:
        diffusion.p_sample(model, x_T, label=y, use_ddim=True, graph=False)
        torch.cuda.synchronize()
    once = span_totals(eager)
    kernel_ms = sum(e.duration_ns() for e in eager.profiler.kineto_results.events()
                    if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()) / 1e6
    for name in (GN, CONV, ATTN):
        # a graph call runs its eager step and its capture's step through the
        # UNet, two of the eager call's four, and only the eager one on the device
        assert totals[name]["count"] == once[name]["count"]
        assert 0 < totals[name]["device_ms"] <= once[name]["device_ms"]
    assert sum(once[name]["device_ms"] for name in (GN, CONV, ATTN)) <= kernel_ms
