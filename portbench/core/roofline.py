"""The yardstick's arithmetic: the chip's peaks, the model's operations
counted on the benchmark's own reference model, and each attention call's
operations and bytes.

Peaks are NVIDIA's H100 SXM data sheet's dense rates at the 700 W limit: the
bf16 tensor cores for bfloat16 cells and the TF32 tensor cores for float32
ones (the highest rate at which the chip takes any float32 operand, so that
no float32 path, the 3xTF32 attention included, can read above it), and the
HBM3 bandwidth.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 494.7e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def model_flops(cfg: dict, batch: int, train: bool) -> float:
    """Operations of one forward of the reference model at ``batch`` rows,
    or of one training loss and its backward with respect to the weights,
    as ``FlopCounterMode`` counts them on the meta device (matrix products,
    convolutions and attention's two products; no elementwise work)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.diffusion import train_loss
    from ..reference.unet import PlainUNet, param_shapes

    dev = torch.device("meta")
    params = {k: torch.empty(s, device=dev, requires_grad=train)
              for k, s in param_shapes(cfg).items()}
    r, c = cfg["resolution"], cfg["in_channels"]
    x = torch.empty((batch, r, r, c), device=dev)
    t = torch.empty((batch,), device=dev)
    y = (torch.empty((batch, cfg["num_classes"]), device=dev) if cfg["multitags"]
         else torch.ones((batch,), device=dev))
    model = PlainUNet(cfg, params)
    with FlopCounterMode(display=False) as counter:
        if train:
            loss = train_loss(model, x, y, t, torch.empty_like(x), None, cfg["head"],
                              cfg["logsnr_min"], cfg["logsnr_max"]).sum()
            torch.autograd.grad(loss, list(params.values()))
        else:
            with torch.no_grad():
                model(x, t, y)
    return float(counter.get_total_flops())


def attention_shapes(cfg: dict) -> List[Tuple[int, int, int]]:
    """(T, heads, head dim) of every attention block of one forward."""
    from ..reference.unet import blocks, heads

    out, res = [], cfg["resolution"]
    for key, _, cout, resampling, has_attn in blocks(cfg):
        res = res // 2 if resampling == "down" else res * 2 if resampling == "up" else res
        if has_attn:
            n = heads(cfg, cout)
            out.append((res * res, n, cout // n))
        if key == "middle.0":
            n = heads(cfg, cout)
            out.append((res * res, n, cout // n))
    return out


def attention_least_s(cfg: dict, batch: int, dtype: str, backward: bool) -> float:
    """The least time of one forward's attention calls at ``batch`` rows
    (with ``backward``, and of their backward): per call the larger of its
    operations over the dtype's peak and its bytes over the HBM bandwidth.
    Operations are the algorithm's, 4·T²·C a (row, head) forward and 8·T²·C
    backward, whatever a kernel recomputes; bytes read each input and write
    each output once: qkv in and the output out; the backward reads qkv and
    the output's gradient and writes the gradient of qkv."""
    s = DTYPE_BYTES[dtype]
    total = 0.0
    for T, n, c in attention_shapes(cfg):
        rows = batch * n
        fwd_ops, fwd_bytes = 4.0 * T * T * c * rows, 4.0 * T * c * rows * s
        total += max(fwd_ops / PEAK_FLOPS[dtype], fwd_bytes / PEAK_BYTES)
        if backward:
            bwd_ops, bwd_bytes = 8.0 * T * T * c * rows, 7.0 * T * c * rows * s
            total += max(bwd_ops / PEAK_FLOPS[dtype], bwd_bytes / PEAK_BYTES)
    return total
