"""Activation checkpointing of the UNet's blocks (counterpart of JAX's
``nn.remat`` in ``vdiff_tpu/models/unet.py::UNet._block``).

:func:`checkpoint_block` runs one down or up block (a ``ResidualBlock`` or a
residual block followed by attention) with its activations recomputed in the
backward, through :func:`checkpoint_region`: non-reentrant
``torch.utils.checkpoint`` keeps a region's inputs and recomputes whatever
the ops inside saved.

* ``policy=None`` (``UNet(remat=True)``): the whole block is one region and
  nothing inside it is kept, as ``nn.remat`` without a policy does.
* ``policy="conv"`` (``UNet(remat_policy="conv")``): the block runs as
  regions written by hand (``forward_saving_convs`` of each block), each
  ending at one of the outputs JAX names ``"unet_mm"``, so that those are
  kept as the next region's inputs and what lies between them recomputes:

  - the 1x1 skip conv: the (concatenated, resampled) block input → skip;
  - conv1: GroupNorm → SiLU → resample → conv1, whose output is kept;
  - conv2: the FiLM Dense (``fc``, not named in JAX either) → GroupNorm →
    FiLM → SiLU → dropout → conv2;
  - the qkv projection: GroupNorm → ``proj_in``, whose output is kept;
  - the attention: the kernels' forward, whose output is kept (as
    ``proj_out``'s saved input); ``proj_out`` and the residual adds run
    outside any region and keep nothing else.

  What stays until the backward is therefore the block's inputs, conv1's
  output, and in an attention block its input, qkv and the attention output:
  the named outputs the backward reads, as XLA keeps them. JAX keeps conv2's
  and the skip's outputs where an attention block reads their sum; the port
  keeps the sum, one tensor for two. conv2's output of a block without
  attention and ``proj_out``'s output are read by an add only, and neither
  framework keeps them.

A region stops its recompute once the last tensor it saved is back, and an
op saves its inputs before it runs: the conv that ends a region is never run
again. The attention forward does run again, once per attention block in both
modes, because ``torch.autograd.Function`` saves after its forward; JAX
re-runs its kernel too, because the kernel's residuals carry no name.

Dropout draws its bits from an explicit ``torch.Generator``, which
``torch.utils.checkpoint`` does not restore (it restores the global
generators only, and this module asks for none of that). The recompute would
draw new bits and the gradient would be wrong without a word. So
:func:`checkpoint_region` snapshots the caller's generator at the region's
entry (``get_state()``: the host copy of a CPU generator's state, a CUDA
generator's seed and offset, no sync), builds the region's generator from
that snapshot in the forward and again in the recompute, and leaves the
caller's generator where the region left it. Both passes draw the same bits,
and the caller's generator ends in the state it would reach without remat: a
step with remat and a step without it, from one generator, are one
computation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

POLICIES = (None, "conv")


def check_policy(policy: Optional[str]) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")


def checkpoint_region(fn, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)``, or ``fn(*args, generator=g)`` where ``generator`` is
    given, with what its ops save recomputed in the backward; ``g`` is built
    from a snapshot of ``generator`` (see the module docstring)."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    state = generator.get_state()
    end = []

    def run(*args):
        gen = torch.Generator(device=generator.device)
        gen.set_state(state)
        out = fn(*args, generator=gen)
        end[:] = [gen.get_state()]  # the recompute writes the same state
        return out

    out = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end[0])
    return out


def _block(block, x, skip_in, t_emb, generator=None):
    h = x if skip_in is None else torch.cat([x, skip_in], dim=1)
    return block(h, t_emb, True, generator)


def checkpoint_block(block, x: torch.Tensor, skip_in: Optional[torch.Tensor], t_emb: torch.Tensor,
                     generator: Optional[torch.Generator], policy: Optional[str]) -> torch.Tensor:
    """``block(cat(x, skip_in), t_emb, train=True, generator)`` with its
    activations recomputed in the backward under ``policy`` (see the module
    docstring). The up path's concat runs inside the regions, as JAX's block
    takes ``skip_in``, so the concatenated tensor is not kept either."""
    if policy == "conv":
        return block.forward_saving_convs(x, skip_in, t_emb, generator)
    return checkpoint_region(_block, block, x, skip_in, t_emb, generator=generator)
