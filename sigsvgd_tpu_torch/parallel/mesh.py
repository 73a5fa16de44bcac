"""Device meshes for particle and pair-grid sharding (port of
``sigsvgd_tpu/parallel/mesh.py``).

The JAX mesh becomes a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims: ``("dp",)`` shards the Stein particles (data-parallel
rollouts), ``("dp", "sp")`` also splits the signature-kernel Gram's columns.
The idiom is SPMD processes: every function of the ``parallel`` package
runs on every rank of an initialised process group, as ``shard_map`` runs on
every device. A mesh's ranks are the group's, laid out row-major (rank r at
coordinate ``r // sp, r % sp`` on a 2-D mesh).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Axes = Union[str, Tuple[str, ...]]


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over the initialised process group's ranks.

    ``axis_sizes`` defaults to all ranks on the first axis; ``device_type``
    None means ``"cuda"``, which raises without a card (the tests pass
    ``"cpu"`` on a gloo group). Raises without a process group."""
    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' for a CPU mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or init_distributed)")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [world] + [1] * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
    total = 1
    for s in axis_sizes:
        total *= s
    if total != world:
        raise ValueError(f"mesh {axis_sizes} needs {total} ranks, the group has {world}")
    return init_device_mesh(device_type, axis_sizes, mesh_dim_names=tuple(axis_names))


def _names(axes: Axes) -> Tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def axis_size(mesh: DeviceMesh, axes: Axes) -> int:
    """Ranks along ``axes`` (the product for several)."""
    n = 1
    for a in _names(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh: DeviceMesh, axes: Axes) -> int:
    """This rank's position along ``axes``, row-major for several (JAX's
    ``pos = pos · size(a) + axis_index(a)``)."""
    pos = 0
    for a in _names(axes):
        pos = pos * axis_size(mesh, a) + mesh.get_local_rank(a)
    return pos


def axis_group(mesh: DeviceMesh, axes: Axes):
    """The process group of the ranks that share this rank's coordinates
    off ``axes``: one mesh dim's group, or the whole mesh's for all dims."""
    names = _names(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if set(names) == set(mesh.mesh_dim_names) and mesh.size() == dist.get_world_size():
        if list(names) != list(mesh.mesh_dim_names):
            raise ValueError(f"axes {names} out of the mesh's order {mesh.mesh_dim_names}")
        return dist.group.WORLD
    raise NotImplementedError(f"a group over {names} of a mesh {mesh.mesh_dim_names}")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The torch device a rank computes on: the CPU, or its current card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """This rank's block of ``x``'s leading dim when it is sharded over
    ``axis`` (JAX's ``P(axis)``)."""
    nd = axis_size(mesh, axis)
    if x.shape[0] % nd:
        raise ValueError(f"leading dim {x.shape[0]} does not divide the '{axis}' axis ({nd})")
    n_local = x.shape[0] // nd
    i = axis_index(mesh, axis)
    return x[i * n_local:(i + 1) * n_local]
