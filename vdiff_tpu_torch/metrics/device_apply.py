"""Batched application of the metric nets (counterpart of
``vdiff_tpu/metrics/device_apply.py``).

The metric loops stream numpy NHWC image batches through a network: each
chunk goes to the device as a tensor and its features come back as numpy.
With a data mesh (``--dp`` under torchrun) every rank holds the whole
stream, as every JAX host does; each chunk is edge-padded to one tile that
the world size divides, each rank runs its contiguous slice of the tile and
the slices are all-gathered, so every rank returns every row.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def apply_batched(fn: Callable, x, batch_size: int, device="cuda", mesh=None) -> np.ndarray:
    """Run ``fn`` (a tensor on ``device`` → a tensor) over ``x`` in chunks of
    ``batch_size`` under ``torch.inference_mode``; returns the stacked rows as
    float32 numpy. An empty ``x`` must keep its item shape, (0, H, W, C), and
    gives the empty result of the right feature shape.

    With ``mesh`` (collective: every rank calls it on the same ``x``) the
    tile is ``batch_size`` rounded up to a multiple of the mesh's ranks; a
    short chunk repeats its last row up to the tile, the padded rows are
    computed and dropped."""
    from ..parallel.mesh import all_gather_rows, mesh_group

    x = np.asarray(x)
    if len(x) == 0 and x.ndim < 2:
        raise ValueError("apply_batched: empty input must keep its item shape, e.g. "
                         f"np.zeros((0, H, W, C)) — got shape {x.shape}")
    outs = []
    with torch.inference_mode():
        if mesh is None:
            for s in range(0, max(len(x), 1), batch_size):
                chunk = torch.from_numpy(np.ascontiguousarray(x[s:s + batch_size])).to(device)
                outs.append(fn(chunk).float().cpu().numpy())
            return np.concatenate(outs)
        group = mesh_group(mesh)
        n, r = mesh.size(), torch.distributed.get_rank(group)
        tile = -(-batch_size // n) * n
        per = tile // n
        for s in range(0, max(len(x), 1), tile):
            chunk = x[s:s + tile]
            k = len(chunk)
            if 0 < k < tile:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], tile - k, axis=0)])
            elif k == 0:  # the empty stream: one empty slice per rank
                per = 0
            mine = torch.from_numpy(np.ascontiguousarray(chunk[r * per:(r + 1) * per])).to(device)
            out = all_gather_rows(fn(mine).float().contiguous(), group)
            outs.append(out[:k].cpu().numpy())
    return np.concatenate(outs)


def resolve_eval_mesh(dp: bool, device="cuda"):
    """The eval CLIs' device and ``--dp`` gate → (mesh, device). Without
    ``dp``: no mesh and ``device`` itself (a CUDA one must exist). With it,
    the process joins torchrun's group (:func:`init_distributed`, which stops
    a process started without torchrun) and runs on the rank's device,
    ``cuda:LOCAL_RANK`` for CUDA, with the data mesh over every rank, or no
    mesh in a world of one, where the loops run as on one device."""
    device = torch.device(device)
    if not dp:
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        return None, device
    from ..parallel.mesh import create_mesh, init_distributed, world_size

    device = init_distributed(device, flag="--dp")
    return (create_mesh() if world_size() > 1 else None), device
