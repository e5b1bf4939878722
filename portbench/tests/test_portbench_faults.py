"""A whole run of each cell, cut to a tiny size on the CPU (the look for a
chip skipped), with the timed path sound and then broken underneath: the
sound run is ``correct``, every fault the cell can have is not. The limits
are the cells' own. The control of the sampling cells (the reference in fp8)
fails them too; the train cells' control needs a card
(test_portbench_chip.py)."""

import pytest

from portbench.core.faults import FAULTS
from portbench.core.jobs import SampleJob, TrainJob
from portbench.core.runner import run_cell
from portbench.reference.precision import fp8
from portbench_cells import CELLS, tiny_cell


def _run(name, fault=None, trace=False):
    return run_cell(tiny_cell(name), 2**32 + 17, 0.0, trace, "cpu", setup_clock=lambda: 1.0,
                    fault=fault, log=lambda *a, **k: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = _run(name, trace=name.endswith("b128"))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    result = _run(name, fault)
    assert not result["correct"], (fault, result["checks"])
    assert result["failed"] > 0


@pytest.mark.parametrize("name", ["cifar10_cond.sample_cfg_b128", "celeba.sample_cfg_b32"])
def test_the_fp8_control_fails_the_sampling_limits(name):
    cell = tiny_cell(name, steps=8)
    job = SampleJob(cell, 2**31 + 3, "cpu")
    job.setup()
    job.window(0.0)
    _, x_T, y = job.program_rows()
    numbers = job.numbers(job.reference_rows(x_T, y, quant=fp8), job.reference_rows(x_T, y))
    limits = cell.limits["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), (numbers, limits)


@pytest.mark.parametrize("setting,value", [("lr", 1e-4), ("ema_decay", 0.999),
                                           ("beta2", 0.99)])
@pytest.mark.parametrize("name", ["cifar10_cond.train_f32_b128", "celeba.train_f32_b48"])
def test_a_wrong_optimizer_setting_is_not_correct(name, setting, value):
    """The program's train step built with one optimizer setting changed, the
    reference with the configuration's: past the warm-up, the limits see it."""
    cell = tiny_cell(name)
    job = TrainJob(cell, 2**32 + 29, "cpu")
    kept = cell.config["train"][setting]
    cell.config["train"][setting] = value
    job.setup()
    cell.config["train"][setting] = kept
    numbers = job.numbers(job.prog, job.reference())
    limits = cell.limits["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), (numbers, limits)
