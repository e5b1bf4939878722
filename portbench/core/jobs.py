"""The two kinds of job a traffic mix names (``"job"``), each in three parts:
``setup`` (weights and inputs from the seed, the program built and warmed at
the cell's shapes), ``window`` (the timed work) and ``check`` (the program's
outputs of the timed path against the reference, once the program's state is
freed).

* ``sample``: bulk sampling as the generate CLI runs it. A call is
  ``p_sample`` over the mix's steps at its batch, x_T and labels from the
  seed; calls start while the window's time is under ``--seconds``, and the
  window ends when the last of them has finished. The check samples rows of
  every call's output and runs the reference's DDIM on them.
* ``train``: the train CLI's step. Set-up runs the mix's ``checked_steps``
  through the same call the window uses, numbered from its
  ``checked_from_step`` (past the learning rate's warm-up and where the EMA's
  decay is the configuration's), and reads the loss of each, the first
  clipped gradient (from AdamW's first moment) and the change of the weights
  and of the EMA over them; the window runs further steps on fresh rows and
  ends at a synchronised step boundary. The check runs the reference's steps
  on the same rows and dropout bits, from the same step.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..reference import steps as ref
from ..reference.steps import leaf_norms
from ..reference.unet import param_shapes
from . import faults, program, roofline
from .spec import Cell, model_cfg, sub_seed
from .weights import make_weights, sample_inputs, train_inputs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_precision(traffic: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(traffic["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(traffic["tf32"])
    torch.backends.cudnn.benchmark = bool(traffic["cudnn_benchmark"])


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def leaf_gaps(prog: Dict[str, float], refv: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| over the larger of its ‖ref‖ and the
    median leaf's."""
    med = statistics.median(refv[k] for k in names)
    return {k: abs(prog[k] - refv[k]) / max(refv[k], med, 1e-30) for k in names}


class SampleJob:
    def __init__(self, cell: Cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, torch.device(device), fault
        self.cfg = model_cfg(cell.config)
        self.tr = cell.traffic
        self.batch = self.tr["batch"]
        self.w_guide = cell.config["conditional"]["w_guide"] if self.tr["guidance"] else 0.0
        #: the forward batch of a sampler step: guidance runs the model twice
        self.fwd_batch = self.batch * (2 if self.w_guide else 1)

    def setup(self) -> None:
        clock = _Phases(self.device)
        set_precision(self.tr)
        weights = make_weights(param_shapes(self.cfg), self.seed, self.device)
        model = program.build_model(self.cell.config, weights, DTYPES[self.tr["dtype"]],
                                    self.device).eval()
        del weights
        self.sampler = program.Sampler(self.cell.config, model, self.tr["steps"], self.w_guide)
        if self.fault:
            faults.plant_sampler(self.sampler, self.fault)
        clock("weights and model")
        x_T, y = sample_inputs(self.cfg, self.batch, self.seed, "warmup", self.device)
        self.sampler.run(x_T, y, self.sampler.with_steps(self.tr["warmup_steps"]),
                         graph=self.tr["graph"])
        clock("warm-up call")
        self.phases = clock.phases
        self.sampler.stats = {}

    def window(self, seconds: float, max_units: Optional[int] = None) -> dict:
        self.outputs = []
        sync(self.device)
        t0 = time.perf_counter()
        while not self.outputs or (time.perf_counter() - t0 < seconds
                                   and len(self.outputs) != max_units):
            with torch.profiler.record_function("portbench.sample_call"):
                x_T, y = sample_inputs(self.cfg, self.batch, self.seed, len(self.outputs),
                                       self.device)
                x = self.sampler.run(x_T, y, graph=self.tr["graph"])
                sync(self.device)
            self.outputs.append(x)
        self.elapsed = time.perf_counter() - t0
        self.units = len(self.outputs)
        self.attempted = self.units * self.batch
        return {"samples_per_s": self.attempted / self.elapsed}

    def flops_per_unit(self) -> float:
        """A call's model operations: the steps' forwards at the forward batch."""
        return roofline.model_flops(self.cfg, self.fwd_batch, train=False) * self.tr["steps"]

    def attention_least_s_per_unit(self) -> float:
        per_step = roofline.attention_least_s(self.cfg, self.fwd_batch, self.tr["dtype"], False)
        return per_step * self.tr["steps"]

    def rows(self, n: int):
        """``n`` distinct (call, row) pairs drawn from the seed, alternately
        from the first and the second half of the batch."""
        rng = np.random.default_rng(sub_seed(self.seed, "check rows"))
        half, picked = self.batch // 2, []
        while len(picked) < min(n, self.units * self.batch):
            pair = (int(rng.integers(self.units)),
                    int(rng.integers(half)) + (len(picked) % 2) * half)
            if pair not in picked:
                picked.append(pair)
        return picked

    def program_rows(self):
        """The compared rows of the window's outputs with their x_T and labels;
        frees the program."""
        picked = self.rows(self.cell.limits["compare"]["rows"])
        prog = torch.stack([self.outputs[c][r] for c, r in picked]).float()
        del self.outputs, self.sampler
        free(self.device)
        inputs = {c: sample_inputs(self.cfg, self.batch, self.seed, c, self.device)
                  for c in sorted({c for c, _ in picked})}
        x_T = torch.stack([inputs[c][0][r] for c, r in picked])
        y = torch.stack([inputs[c][1][r] for c, r in picked])
        return prog, x_T, y

    def reference_rows(self, x_T, y, quant=None) -> torch.Tensor:
        weights = make_weights(param_shapes(self.cfg), self.seed, self.device)
        return ref.sample_rows(self.cfg, weights, x_T, y, self.tr["steps"], self.w_guide,
                               self.cell.limits["compare"]["block"], quant=quant)

    @staticmethod
    def numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
        diff = (got - want).flatten(1)
        return {"sample_rms": float(diff.square().mean().sqrt()),
                "sample_max": float(diff.abs().max()),
                "row_rms": diff.square().mean(dim=1).sqrt().tolist(),
                "row_max": diff.abs().amax(dim=1).tolist()}

    def check(self) -> dict:
        prog, x_T, y = self.program_rows()
        return self.numbers(prog, self.reference_rows(x_T, y))


class TrainJob:
    def __init__(self, cell: Cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, torch.device(device), fault
        self.cfg = model_cfg(cell.config)
        self.tr = cell.traffic
        self.batch = self.tr["batch"]
        self.p_uncond = cell.config["conditional"]["p_uncond"]
        self.train_seed = sub_seed(seed, "dropout")
        self.first = self.tr["checked_from_step"]
        self.checked = range(self.first, self.first + self.tr["checked_steps"])

    def inputs(self, step: int) -> dict:
        return train_inputs(self.cfg, self.batch, self.seed, step, self.p_uncond, self.device)

    def setup(self) -> None:
        clock = _Phases(self.device)
        set_precision(self.tr)
        shapes = param_shapes(self.cfg)
        weights = make_weights(shapes, self.seed, self.device)
        model = program.build_model(self.cell.config, weights, DTYPES[self.tr["dtype"]],
                                    self.device)
        del weights
        self.trainer = program.Trainer(self.cell.config, model, self.train_seed, self.first)
        if self.fault:
            faults.plant_trainer(self.trainer, self.fault)
        clock("weights and model")
        losses, grad = [], None
        for step in self.checked:
            losses.append(self.trainer.run(self.inputs(step), step))
            if step == self.first:
                grad = leaf_norms(self.trainer.first_grads())
            clock(f"checked step {step}")
        start = make_weights(shapes, self.seed, self.device)
        self.prog = {
            "loss": [float(v) for v in losses], "grad": grad,
            "change": leaf_norms({k: p.detach() - start[k]
                                   for k, p in self.trainer.params().items()}),
            "ema_change": leaf_norms({k: p - start[k]
                                       for k, p in self.trainer.ema_params().items()})}
        del start
        self.step = self.checked.stop
        clock("readings")
        self.phases = clock.phases

    def window(self, seconds: float, max_units: Optional[int] = None) -> dict:
        sync(self.device)
        t0, n = time.perf_counter(), 0
        while n == 0 or (time.perf_counter() - t0 < seconds and n != max_units):
            with torch.profiler.record_function("portbench.train_step"):
                self.trainer.run(self.inputs(self.step), self.step)
            self.step += 1
            n += 1
        sync(self.device)
        self.elapsed = time.perf_counter() - t0
        self.units = n
        self.attempted = n * self.batch
        return {"train_img_per_s": self.attempted / self.elapsed}

    def flops_per_unit(self) -> float:
        return roofline.model_flops(self.cfg, self.batch, train=True)

    def attention_least_s_per_unit(self) -> float:
        return roofline.attention_least_s(self.cfg, self.batch, self.tr["dtype"], True)

    def reference(self, tf32: bool = False) -> dict:
        """The reference's checked steps from the seed's weights on the same
        rows; with ``tf32`` its matrix products and convolutions in TF32 (the
        float32 control). Frees the program first."""
        self.trainer = None
        free(self.device)
        weights = make_weights(param_shapes(self.cfg), self.seed, self.device)
        batches = [self.inputs(step) for step in self.checked]
        with _tf32(tf32), _autotuner_off():
            return ref.train_steps(self.cfg, self.cell.config["train"], weights, batches,
                                   self.train_seed, self.cell.limits["compare"]["block"],
                                   first_step=self.first)

    @staticmethod
    def numbers(got: dict, want: dict) -> dict:
        """Each step's loss gap (relative); the gap of the first clipped
        gradient's norm, of the norm of the change of the weights and of the
        EMA over the checked steps, each by the worst leaf (``*_gap``, with
        its name) and by the median leaf (``*_median``). The change leaves
        out leaves whose reference gradient is under a thousandth of the
        median leaf's (round-off alone moves them under Adam)."""
        names = list(want["grad"])
        med = statistics.median(want["grad"][k] for k in names)
        moving = [k for k in names if want["grad"][k] >= 1e-3 * med]
        out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
               "left_out": len(names) - len(moving)}
        for key, field, leaves in (("grad", "grad", names), ("change", "change", moving),
                                   ("ema", "ema_change", moving)):
            gaps = leaf_gaps(got[field], want[field], leaves)
            out[f"{key}_leaf"] = max(gaps, key=gaps.get)
            out[f"{key}_gap"] = gaps[out[f"{key}_leaf"]]
            out[f"{key}_median"] = statistics.median(gaps.values())
        return out

    def check(self) -> dict:
        return self.numbers(self.prog, self.reference())


class _Phases:
    """Seconds of each part of a set-up, each ended by a synchronise."""

    def __init__(self, device):
        self.device, self.phases, self.last = device, [], time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.phases.append((name, now - self.last))
        self.last = now


@contextlib.contextmanager
def _autotuner_off():
    """cuDNN's autotuner off for the block: the reference's row blocks have
    shapes of their own, and it gains nothing from choosing their
    algorithms by timing."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 on for the block (the float32 control); else nothing changes."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if on:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


JOBS = {"sample": SampleJob, "train": TrainJob}
