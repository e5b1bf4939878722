"""Tests that need a CUDA card (``python -m pytest portbench/tests -m chip``):
each cell cut to a tiny size through the card's path (the hand kernels, the
CUDA graph, the profiler), sound and broken; and the controls at the cells'
own sizes, which have to fail the cells' limits."""

import pytest

from portbench.core.faults import FAULTS
from portbench.core.jobs import SampleJob, TrainJob
from portbench.core.runner import run_cell
from portbench.core.spec import load_cell
from portbench.reference.precision import fp8
from portbench_cells import CELLS, ROOT, cuda, tiny_cell  # noqa: F401 (fixture)

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cells_on_the_card(cuda, name):  # noqa: F811
    def run(fault=None, trace=False):
        return run_cell(tiny_cell(name), 2**31 + 11, 0.0, trace, cuda, setup_clock=lambda: 1.0,
                        fault=fault, log=lambda *a, **k: None)

    sound = run(trace=True)
    assert sound["correct"], sound["checks"]
    assert sound["device"]["platform"] == "gpu" and sound["device"]["busy_s"] > 0
    assert sound["metrics"] and sound["breakdown"]["device_ops"]
    for fault in FAULTS:
        assert not run(fault)["correct"], fault


@pytest.mark.parametrize("name", ["cifar10_cond.train_f32_b128", "celeba.train_f32_b48"])
def test_the_tf32_control_fails_the_train_limits(cuda, name):  # noqa: F811
    cell = load_cell(name, ROOT)
    job = TrainJob(cell, 2**31 + 21, cuda)
    job.setup()
    want = job.reference()
    numbers = job.numbers(job.reference(tf32=True), want)
    assert any(numbers[k] > v for k, v in cell.limits["limits"].items()), numbers


def test_the_fp8_control_fails_the_sampling_limits(cuda):  # noqa: F811
    cell = load_cell("cifar10_cond.sample_cfg_b128", ROOT)
    job = SampleJob(cell, 2**31 + 23, cuda)
    job.setup()
    job.window(0.0)
    _, x_T, y = job.program_rows()
    numbers = job.numbers(job.reference_rows(x_T, y, quant=fp8), job.reference_rows(x_T, y))
    assert any(numbers[k] > v for k, v in cell.limits["limits"].items()), numbers
