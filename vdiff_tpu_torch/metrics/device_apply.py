"""Batched application of the metric nets (counterpart of
``vdiff_tpu/metrics/device_apply.py``).

The metric loops stream numpy NHWC image batches through a network on one
device: each chunk goes to the device as a tensor and its features come back
as numpy. Sharding the batches over several devices (the JAX package's
``--dp`` mesh) is the multi-GPU slice's, ROADMAP A10.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

NOT_PORTED = "is not ported yet (ROADMAP.md queue A: {})"


def apply_batched(fn: Callable, x, batch_size: int, device="cuda") -> np.ndarray:
    """Run ``fn`` (a tensor on ``device`` → a tensor) over ``x`` in chunks of
    ``batch_size`` under ``torch.inference_mode``; returns the stacked rows as
    float32 numpy. An empty ``x`` must keep its item shape, (0, H, W, C), and
    gives the empty result of the right feature shape."""
    x = np.asarray(x)
    if len(x) == 0 and x.ndim < 2:
        raise ValueError("apply_batched: empty input must keep its item shape, e.g. "
                         f"np.zeros((0, H, W, C)) — got shape {x.shape}")
    outs = []
    with torch.inference_mode():
        for s in range(0, max(len(x), 1), batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(x[s:s + batch_size])).to(device)
            outs.append(fn(chunk).float().cpu().numpy())
    return np.concatenate(outs)


def resolve_eval_mesh(dp: bool):
    """The eval CLIs' ``--dp`` gate: None on one device; ``dp`` (metric
    batches sharded over several devices) stops the CLI, naming its ROADMAP
    item, as the train CLI refuses ``--distributed``."""
    if dp:
        raise SystemExit("--dp " + NOT_PORTED.format("A10"))
    return None
