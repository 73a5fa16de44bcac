"""Process-group set-up and global meshes (port of
``sigsvgd_tpu/parallel/distributed.py``).

One process a rank (SPMD, as torchrun starts them): :func:`init_distributed`
joins the group torchrun describes in its environment (or the one the
caller names), :func:`global_particle_mesh` lays a ``("dp", "sp")`` mesh
over all its ranks, and :func:`make_global_particles` gives each rank its
rows of a draw every rank makes alike.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import local_rows, make_mesh, mesh_device


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device_type: Optional[str] = None) -> int:
    """Join the process group and return this process's rank (0 without
    one). Reads torchrun's ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (and
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``) unless given. With
    one process and no ``init_method`` it does nothing. ``device_type``
    None means ``"cuda"``: the backend is NCCL and each rank takes the card
    ``LOCAL_RANK`` modulo the cards present; ``"cpu"`` takes gloo."""
    if dist.is_initialized():
        return dist.get_rank()
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    if world_size <= 1 and init_method is None:
        return 0
    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device_type='cpu'")
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return rank


def global_particle_mesh(sp: int = 1, axis_names: Tuple[str, str] = ("dp", "sp"),
                         device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over all the group's ranks, ``dp = world // sp``: consecutive
    ranks share a 'dp' block, so a row block's column split stays on
    neighbouring ranks."""
    world = dist.get_world_size()
    if world % sp:
        raise ValueError(f"sp={sp} does not divide the {world} ranks")
    return make_mesh([world // sp, sp], axis_names, device_type)


def make_global_particles(generator: torch.Generator, shape: Sequence[int],
                          mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """This rank's rows of standard normal particles of ``shape``: every rank
    draws the whole tensor from its generator (seeded alike on every rank)
    and keeps its block of ``axis``."""
    x = torch.randn(tuple(shape), generator=generator, device=mesh_device(mesh))
    return local_rows(x, mesh, axis)
