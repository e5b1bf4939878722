"""vdiff_tpu_torch — the PyTorch/CUDA port of ``vdiff_tpu`` for NVIDIA Hopper.

This slice covers the sampling path: log-SNR schedules and posterior tables
(``ops.numerics``), the improved-DDPM UNet's inference forward
(``models.unet``) with hand-written CUDA attention kernels (``ops.attention``,
``csrc/``), the DDIM/ancestral/CFG sampler (``diffusion``) and the sampling CLI
(``python -m vdiff_tpu_torch.generate``). It imports torch and numpy, never
JAX; ``vdiff_tpu`` stays the reference it is tested against.

The names below load with their modules on first use, so that
``python -m vdiff_tpu_torch.quality_gate``, which only launches the CLIs,
imports no torch.
"""

import importlib

_EXPORTS = {"DATA_INFO": ".data", "GaussianDiffusion": ".diffusion", "UNet": ".models.unet",
            "get_logsnr_schedule": ".ops.numerics"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
