"""Lower precisions the reference can be computed in, for the controls.

:func:`fp8` rounds a tensor to float8 e4m3 under a per-tensor scale (its
largest magnitude to 448, the format's largest), the way an fp8 matrix
product takes its operands, and returns it in its own dtype. It is the
precision next below bfloat16, the sampling cells' stated precision.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
