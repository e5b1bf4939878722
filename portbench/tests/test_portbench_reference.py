"""The reference against the program's CPU twins at a tiny width, on the same
handed-in weights, rows, draws and x_T, in float32: the forward, the DDIM
sampler with guidance, and the train step (loss, backward, clip, AdamW, EMA,
with the same dropout bits)."""

import pytest
import torch

from portbench.core import program
from portbench.core.jobs import SampleJob, TrainJob
from portbench.core.spec import model_cfg
from portbench.core.weights import make_weights, sample_inputs
from portbench.reference.unet import PlainUNet, param_shapes
from portbench_cells import tiny_cell

NAMES = ("cifar10_cond", "celeba")


@pytest.mark.parametrize("name", NAMES)
def test_weights_fit_the_program_by_name_and_shape(name):
    cell = tiny_cell(f"{name}.sample_cfg_b{'128' if name == 'cifar10_cond' else '32'}")
    cfg = model_cfg(cell.config)
    shapes = param_shapes(cfg)
    model = program.build_model(cell.config, make_weights(shapes, 1, "cpu"), torch.float32, "cpu")
    own = model.state_dict()
    assert set(own) == set(shapes)
    assert all(tuple(own[k].shape) == tuple(s) for k, s in shapes.items())
    assert all(bool(v.ne(0).any()) for v in own.values())


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_the_program(name):
    cell = tiny_cell(f"{name}.sample_cfg_b{'128' if name == 'cifar10_cond' else '32'}")
    cfg = model_cfg(cell.config)
    weights = make_weights(param_shapes(cfg), 2, "cpu")
    model = program.build_model(cell.config, weights, torch.float32, "cpu")
    x, y = sample_inputs(cfg, 4, 2, 0, "cpu")
    y[0] = 0  # the null label
    t = torch.rand(4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = model(x, t, y), PlainUNet(cfg, weights)(x, t, y)
    assert (got - want).abs().max() <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("name", ["cifar10_cond.sample_cfg_b128", "celeba.sample_cfg_b32"])
def test_guided_ddim_matches_the_program(name):
    cell = tiny_cell(name, steps=4)
    cell.traffic["dtype"] = "float32"
    job = SampleJob(cell, 2**40 + 9, "cpu")
    job.setup()
    job.window(0.0)
    got, x_T, y = job.program_rows()
    numbers = job.numbers(got, job.reference_rows(x_T, y))
    assert numbers["sample_max"] < 1e-4


@pytest.mark.parametrize("name", ["cifar10_cond.train_f32_b128", "celeba.train_f32_b48"])
def test_train_steps_match_the_program(name):
    job = TrainJob(tiny_cell(name), 2**33 + 5, "cpu")
    job.setup()
    numbers = job.numbers(job.prog, job.reference())
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4 and numbers["ema_median"] < 1e-4


@pytest.mark.parametrize("name", ["cifar10_cond.sample_cfg_b128", "celeba.sample_cfg_b32"])
def test_an_unguided_mix_is_unguided_on_both_sides(name):
    cell = tiny_cell(name, steps=4)
    cell.traffic.update(dtype="float32", guidance=False)
    job = SampleJob(cell, 2**40 + 11, "cpu")
    job.setup()
    assert job.sampler.diffusion.w_guide == 0.0 and job.fwd_batch == job.batch
    job.window(0.0)
    got, x_T, y = job.program_rows()
    assert job.numbers(got, job.reference_rows(x_T, y))["sample_max"] < 1e-4


@pytest.mark.parametrize("name", ["cifar10_cond.train_f32_b128", "celeba.train_f32_b48"])
def test_the_checked_steps_run_past_the_warm_up(name):
    """The checked steps take the configuration's learning rate, not a
    warm-up fraction of it, and the EMA's decay is the configuration's."""
    cell = tiny_cell(name)
    train, first = cell.config["train"], cell.traffic["checked_from_step"]
    assert first >= train["warmup"]
    assert (1.0 + first + 1) / (10.0 + first + 1) >= train["ema_decay"]
    job = TrainJob(cell, 2**33 + 7, "cpu")
    job.setup()
    assert job.trainer.optimizer.learning_rate() == train["lr"]
    assert job.step == first + cell.traffic["checked_steps"]
