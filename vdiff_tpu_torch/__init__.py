"""vdiff_tpu_torch — the PyTorch/CUDA port of ``vdiff_tpu`` for NVIDIA Hopper.

This slice covers the sampling path: log-SNR schedules and posterior tables
(``ops.numerics``), the improved-DDPM UNet's inference forward
(``models.unet``) with hand-written CUDA attention kernels (``ops.attention``,
``csrc/``), the DDIM/ancestral/CFG sampler (``diffusion``) and the sampling CLI
(``python -m vdiff_tpu_torch.generate``). It imports torch and numpy, never
JAX; ``vdiff_tpu`` stays the reference it is tested against.
"""

from .data import DATA_INFO
from .diffusion import GaussianDiffusion
from .models.unet import UNet
from .ops.numerics import get_logsnr_schedule

__all__ = ["DATA_INFO", "GaussianDiffusion", "UNet", "get_logsnr_schedule"]
