"""Process groups and device meshes (counterpart of ``vdiff_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets XLA place the
collectives. The port runs one process per GPU, as ``torchrun`` starts them:

* ``jax.distributed.initialize``     → :func:`init_distributed`, which reads
                                       torchrun's ``RANK``, ``WORLD_SIZE`` and
                                       ``LOCAL_RANK`` and joins the group: NCCL
                                       on ``cuda:LOCAL_RANK``, gloo on the CPU
* ``Mesh(devices, ("data",))``       → :func:`create_mesh`, a ``DeviceMesh``
                                       over every rank, 1-D ``("data",)`` or
                                       2-D ``("data", "fsdp")`` for HSDP
* ``shard_batch`` / ``batch_sharding`` + ``make_array_from_process_local_data``
                                     → :func:`shard_batch`, this rank's
                                       contiguous rows of a global batch
* ``sync_global_devices``            → a barrier
* a replicated jit output            → :func:`all_gather_rows`, the ranks'
                                       slices concatenated in rank order
* the CLIs' clock broadcast          → :func:`broadcast_object` of rank 0's
                                       timestamp

Outside a process group every helper is the one-process identity, so the
single-card paths call them unconditionally.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"

_LAUNCH = ("python -m torch.distributed.run --standalone --nproc_per_node=<GPUs> "
           "-m vdiff_tpu_torch.<cli> ...")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_leader() -> bool:
    return rank() == 0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     flag: str = "--distributed") -> torch.device:
    """Join the process group of this run and return this rank's device:
    ``cuda:LOCAL_RANK`` (made current) for a CUDA ``device``, the CPU for
    ``cpu``. The backend follows the device, NCCL on CUDA and gloo on the CPU;
    a group that already exists is kept when its backend is that one, or
    when it is gloo, which carries CUDA tensors too (a launcher's choice
    where NCCL cannot serve, as for two ranks sharing one card: the device is
    then the current CUDA device), and refused otherwise. Rank and world size
    come from torchrun's environment (``init_method`` defaults to its
    ``env://`` rendezvous); a process started without them stops with the
    command that launches ``flag``'s run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    want = _backend(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want and have != "gloo":
            raise SystemExit(f"the process group runs {have}; a {device.type} run needs {want}")
        if device.type == "cuda" and have == "gloo":
            return torch.device("cuda", torch.cuda.current_device())
    elif "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"{flag} runs one process per device under torchrun ({_LAUNCH}); "
                         "RANK and WORLD_SIZE are not set")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(want, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device


def create_mesh(fsdp_size: int = 1):
    """A ``DeviceMesh`` over every rank: 1-D ``("data",)``, or with
    ``fsdp_size > 1`` the 2-D ``("data", "fsdp")`` hybrid mesh, whose minor
    axis of ``fsdp_size`` ranks holds the sharded state (HSDP) while the batch
    splits over every rank. Its devices are the group's: CUDA under NCCL, the
    CPU under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if fsdp_size and fsdp_size > 1:
        if n % fsdp_size:
            raise ValueError(f"fsdp_size {fsdp_size} must divide the world size {n}")
        return init_device_mesh(device_type, (n // fsdp_size, fsdp_size),
                                mesh_dim_names=(DATA_AXIS, FSDP_AXIS))
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def mesh_group(mesh):
    """The process group over all of ``mesh``'s ranks (its own for a 1-D
    mesh; the world for the 2-D one, which spans every rank)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def row_range(batch: int, index: Optional[int] = None, count: Optional[int] = None
              ) -> Tuple[int, int]:
    """The contiguous rows [start, stop) of a ``batch`` that the ``index``-th
    of ``count`` ranks holds (defaults: this rank of the world). The batch
    must divide."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    if batch % count:
        raise ValueError(f"a batch of {batch} does not split over {count} ranks")
    per = batch // count
    return index * per, (index + 1) * per


def shard_batch(*arrays):
    """Each array's rows of this rank: the global batch split into contiguous
    equal slices in rank order (None passes through). One process keeps it
    whole."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        start, stop = row_range(a.shape[0])
        out.append(a[start:stop])
    return tuple(out) if len(out) > 1 else out[0]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank. One process returns ``x``."""
    return all_gather_along(x, 0, group)


def all_gather_along(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank (one ``all_gather``, which gloo also runs on CUDA
    tensors). One process returns ``x``."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce_mean_(x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced in place by its mean over the ranks."""
    if world_size() > 1:
        dist.all_reduce(x)
        x.div_(world_size())
    return x


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def leader_value(fn: Callable, mesh=None):
    """``fn()`` computed on rank 0 alone and its value broadcast to every
    rank (host math whose inputs every rank holds); without a ``mesh``, the
    caller's own ``fn()``."""
    if mesh is None:
        return fn()
    return broadcast_object(fn() if is_leader() else None)


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier over every rank (``name`` documents the call site)."""
    del name
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
