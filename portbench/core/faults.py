"""Faults planted under the timed path, for the tests and the readings that
show the comparison catches them. A run of the benchmark plants none.

* ``unchanged``: the step returns its state unchanged (the sampler returns
  x_T; the train step updates nothing);
* ``half_batch``: half of the batch is left out (the sampler's second half of
  rows never runs and reads zero; the train step takes the mean over the
  first half);
* ``altered``: an answer is altered where it is produced (one element of
  every sample moved by 1; the loss the step returns moved by 1%).
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def plant_sampler(sampler, fault: str):
    call = sampler.run

    def broken(x_T, y, diffusion=None, graph=True):
        if fault == "unchanged":
            return x_T.clone()
        if fault == "half_batch":
            h = x_T.shape[0] // 2
            out = torch.zeros_like(x_T)
            out[:h] = call(x_T[:h], y[:h], diffusion, graph)
            return out
        out = call(x_T, y, diffusion, graph).clone()
        out.view(out.shape[0], -1)[:, 0] += 1.0
        return out

    sampler.run = broken
    return sampler


def plant_trainer(trainer, fault: str):
    call = trainer.run

    def broken(batch, step):
        if fault == "unchanged":
            return torch.zeros((), device=batch["x"].device)
        if fault == "half_batch":
            h = batch["x"].shape[0] // 2
            return call({k: v[:h] for k, v in batch.items()}, step)
        return call(batch, step) * 1.01

    trainer.run = broken
    return trainer
