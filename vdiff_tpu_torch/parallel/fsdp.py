"""Sharded training state (counterpart of ``vdiff_tpu/parallel/fsdp.py``).

The JAX package annotates every leaf of its TrainState with a sharding and
lets GSPMD insert the all-gathers and reduce-scatters. The port shards the
UNet with FSDP2's ``fully_shard``: each down, middle and up block is one unit
(its parameters all-gathered before its forward and its backward, freed after
each), then the root takes what is left. Every parameter becomes a ``DTensor``
sharded on dim 0 over the mesh's FSDP axis; the Adam moments follow their
parameters, and the EMA model, sharded the same way, updates shard by shard.
On the 2-D ``("data", "fsdp")`` mesh FSDP2 replicates over ``data`` and shards
over ``fsdp`` (HSDP).

Parameters stay float32 (no ``MixedPrecisionPolicy``): the UNet casts them at
use, as on one card, so the sharded step computes what the replicated one
does.

JAX's ``leaf_partition_spec`` (which dimension each leaf shards on, which small
leaves stay whole) is GSPMD layout and is not ported: FSDP2 places every
parameter on dim 0.

Checkpoints keep the single-card layout: :func:`full_state_dict` and
:func:`full_optimizer_state` gather whole tensors (every rank calls them),
:func:`load_full_state_dict_` and :func:`load_full_optimizer_state_` take a
whole-tensor state back into the shards.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch.distributed.tensor import DTensor

from .mesh import DATA_AXIS, FSDP_AXIS


def resolve_fsdp_axis(mesh) -> str:
    """The mesh axis the state is sharded over: ``fsdp`` on the hybrid mesh,
    else ``data`` (full sharding over every rank)."""
    return FSDP_AXIS if FSDP_AXIS in (mesh.mesh_dim_names or ()) else DATA_AXIS


def fsdp_units(model) -> list:
    """The UNet's blocks that are FSDP units, in forward order: every entry of
    each down level, the three middle blocks, every entry of each up level."""
    units = [blk for level in model.downsamples.values() for blk in level]
    units += list(model.middle)
    units += [blk for level in model.upsamples.values() for blk in level]
    return units


def shard_model(model, mesh):
    """Shard ``model`` (a UNet) in place with FSDP2 over ``mesh``: each block
    of :func:`fsdp_units`, then the root. A block's ``forward_saving_convs``
    (remat's "conv" regions call it, not ``forward``) gathers its parameters
    as its forward does. Returns the model."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    for blk in fsdp_units(model):
        fully_shard(blk, mesh=mesh)
        if hasattr(blk, "forward_saving_convs"):
            register_fsdp_forward_method(blk, "forward_saving_convs")
    fully_shard(model, mesh=mesh)
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_group(tensors: Iterable[torch.Tensor]):
    """The process group over which the DTensors in ``tensors`` are sharded,
    or None when none is sharded across more than one rank."""
    for t in tensors:
        if isinstance(t, DTensor):
            dims = [i for i, p in enumerate(t.placements) if p.is_shard()]
            if dims and t.device_mesh.size(dims[0]) > 1:
                return t.device_mesh.get_group(dims[0])
            return None
    return None


def state_bytes_per_device(model, optimizer=None, ema_model=None) -> int:
    """Bytes of training state held on this rank's device: the local shards
    of the parameters (FSDP's DTensor shards, or the row blocks that
    :func:`.tp.tp_shard_model_` keeps), of both Adam moments and of the EMA."""
    tensors = list(model.parameters())
    if ema_model is not None:
        tensors += list(ema_model.parameters())
    if optimizer is not None:
        adamw = getattr(optimizer, "adamw", optimizer)
        for state in adamw.state.values():
            tensors += [v for k, v in state.items() if k in ("exp_avg", "exp_avg_sq")]
    return sum(local(t).numel() * local(t).element_size() for t in tensors)


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local_chunk(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's part of a whole tensor, as ``like`` holds it: for each mesh
    dimension that shards, the coordinate's ``torch.chunk`` along its tensor
    dimension (FSDP2's and DTensor's rule; a rank past the last chunk holds
    an empty one)."""
    mesh, coord = like.device_mesh, like.device_mesh.get_coordinate()
    out = full
    for i, p in enumerate(like.placements):
        if p.is_shard():
            chunks = torch.chunk(out, mesh.size(i), dim=p.dim)
            if coord[i] < len(chunks):
                out = chunks[coord[i]]
            else:
                out = out.narrow(p.dim, 0, 0)
    return out


@torch.no_grad()
def full_state_dict(module) -> dict:
    """``module.state_dict()`` with whole tensors on the CPU. Under FSDP every
    rank must call it (each DTensor is all-gathered)."""
    return {k: _full(v.detach()).cpu() for k, v in module.state_dict().items()}


@torch.no_grad()
def load_full_state_dict_(module, state_dict: dict) -> None:
    """Copy a whole-tensor state dict into ``module``'s parameters and
    buffers, each rank its own shards; the keys must match exactly."""
    own = module.state_dict()
    if own.keys() != state_dict.keys():
        missing, extra = own.keys() - state_dict.keys(), state_dict.keys() - own.keys()
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    for k, dst in own.items():
        src = state_dict[k]
        if isinstance(dst, DTensor):
            dst.to_local().copy_(_local_chunk(src.to(dst.device), dst))
        else:
            dst.copy_(src)


def full_optimizer_state(adamw: torch.optim.Optimizer) -> dict:
    """``adamw.state_dict()`` with every DTensor state (the moments) gathered
    whole onto the CPU. Every rank must call it under FSDP."""
    sd = adamw.state_dict()
    sd["state"] = {i: {k: _full(v).cpu() if torch.is_tensor(v) else v for k, v in s.items()}
                   for i, s in sd["state"].items()}
    return sd


def load_full_optimizer_state_(adamw: torch.optim.Optimizer, sd: dict) -> None:
    """Load a whole-tensor optimizer state: each moment of a sharded parameter
    becomes a DTensor laid out as the parameter, holding this rank's part."""
    params = [p for g in adamw.param_groups for p in g["params"]]
    state = {}
    for i, s in sd["state"].items():
        p = params[int(i)]
        if isinstance(p, DTensor):
            s = {k: DTensor.from_local(_local_chunk(v.to(p.device), p).clone(), p.device_mesh,
                                       p.placements, shape=p.shape, stride=p.stride())
                 if torch.is_tensor(v) and v.shape == p.shape else v for k, v in s.items()}
        state[i] = s
    adamw.load_state_dict({**sd, "state": state})


def gather_into_(plain, sharded) -> None:
    """Copy ``sharded``'s parameters, gathered whole, into ``plain``, an
    unsharded module of the same structure. Every rank must call it."""
    with torch.no_grad():
        for dst, src in zip(plain.parameters(), sharded.parameters()):
            dst.copy_(_full(src))

