"""Triangle-mesh obstacles for planning scenes (port of
``sigsvgd_tpu/models/robot/mesh_scene.py``).

The host builds each mesh obstacle's distance grid once: the C++ BVH engine
(``native/collision.py``) gives unsigned point-to-mesh distances over a
lattice spanning the scene's workspace, and a flood fill from the lattice's
border (``scipy.ndimage.label``) finds the cells enclosed by a closed mesh,
whose distances turn negative. The grid, less the obstacle's ``margin``, is
cached on the host per (obstacle, workspace) and as a tensor per device, so
a cost on the card uploads it once. The scene's SDF for the obstacle is a
differentiable trilinear lookup in it, with ``jnp.clip``'s gradient at the
lattice border and its gather's clamped indices, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["MeshObstacle", "SdfGrid", "mesh_sdf_grid", "grid_sdf", "write_stl", "box_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshObstacle:
    """A posed STL mesh obstacle. ``rot`` row-major 3×3 world-from-mesh."""

    path: str
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rot: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)
    margin: float = 0.02  # shell inflation (occupied ⇔ dist ≤ margin)
    resolution: int = 48  # grid points per axis over the scene workspace


@dataclasses.dataclass(frozen=True, eq=False)
class SdfGrid:
    """Dense distance grid over an axis-aligned box (host numpy), with its
    tensors on each device it was used on."""

    origin: Tuple[float, float, float]
    spacing: Tuple[float, float, float]
    values: np.ndarray  # [nx, ny, nz] float32 (signed distance − margin)
    _on_device: Dict[torch.device, tuple] = dataclasses.field(
        default_factory=dict, repr=False)

    def tensors(self, device: torch.device) -> tuple:
        """``(values, origin, spacing, upper clip)`` as fp32 tensors on
        ``device``, uploaded on first use."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = (
                torch.from_numpy(self.values).to(device),
                torch.tensor(self.origin, dtype=torch.float32, device=device),
                torch.tensor(self.spacing, dtype=torch.float32, device=device),
                torch.tensor(self.values.shape, dtype=torch.float32, device=device)
                - 1.000001,
            )
        return self._on_device[device]


@lru_cache(maxsize=64)
def _cached_grid(obstacle: MeshObstacle, low: Tuple[float, float, float],
                 high: Tuple[float, float, float]) -> SdfGrid:
    from scipy import ndimage

    from ...native.collision import TriMesh

    mesh = TriMesh(obstacle.path)
    n = obstacle.resolution
    lo = np.asarray(low, np.float64)
    hi = np.asarray(high, np.float64)
    axes = [np.linspace(lo[d], hi[d], n) for d in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = np.asarray(obstacle.rot, np.float32).reshape(3, 3)
    tf[:3, 3] = obstacle.position
    dists = mesh.point_distances(pts.astype(np.float32), transform=tf)
    dists = dists.astype(np.float32).reshape(n, n, n)
    spacing = (hi - lo) / (n - 1)
    # the BVH distance is unsigned: flood-fill the lattice from its border
    # through cells farther than one cell diagonal from the surface; the
    # components not reached are a closed mesh's interior, where the signed
    # distance is −(distance to the surface). An open mesh encloses none.
    passable = dists > float(np.linalg.norm(spacing))
    labels, _ = ndimage.label(passable)
    border_labels = np.unique(np.concatenate([
        labels[0].ravel(), labels[-1].ravel(), labels[:, 0].ravel(),
        labels[:, -1].ravel(), labels[:, :, 0].ravel(), labels[:, :, -1].ravel(),
    ]))
    outside = np.isin(labels, border_labels[border_labels != 0])
    dists = np.where(passable & ~outside, -dists, dists)
    values = (dists - obstacle.margin).astype(np.float32)
    return SdfGrid(tuple(map(float, lo)), tuple(map(float, spacing)), values)


def mesh_sdf_grid(obstacle: MeshObstacle, workspace_low: Tuple[float, float, float],
                  workspace_high: Tuple[float, float, float]) -> SdfGrid:
    """The obstacle's distance grid over the workspace, built once on the host."""
    return _cached_grid(obstacle, tuple(workspace_low), tuple(workspace_high))


def grid_sdf(grid: SdfGrid, x: torch.Tensor) -> torch.Tensor:
    """Differentiable trilinear lookup of ``x [..., 3]`` in the grid, on
    ``x``'s device. Queries outside the lattice clamp to its border cell."""
    vals, origin, spacing, upper = grid.tensors(x.device)
    u = (x - origin.to(x.dtype)) / spacing.to(x.dtype)
    # jnp.clip: half the gradient to each side of a tie, as torch's max/min
    u = torch.minimum(torch.maximum(u, torch.zeros_like(u)), upper.to(x.dtype))
    i0 = torch.floor(u)
    f = u - i0
    i0 = i0.long()
    n = vals.shape

    def idx(axis: int, d: int) -> torch.Tensor:
        i = i0[..., axis]
        return torch.clamp(i + 1, max=n[axis] - 1) if d else i

    def at(dx, dy, dz):
        return vals[idx(0, dx), idx(1, dy), idx(2, dz)].to(x.dtype)

    f0, f1, f2 = f[..., 0], f[..., 1], f[..., 2]
    c00 = at(0, 0, 0) * (1 - f0) + at(1, 0, 0) * f0
    c01 = at(0, 0, 1) * (1 - f0) + at(1, 0, 1) * f0
    c10 = at(0, 1, 0) * (1 - f0) + at(1, 1, 0) * f0
    c11 = at(0, 1, 1) * (1 - f0) + at(1, 1, 1) * f0
    c0 = c00 * (1 - f1) + c10 * f1
    c1 = c01 * (1 - f1) + c11 * f1
    return c0 * (1 - f2) + c1 * f2


def write_stl(path: str | Path, triangles: np.ndarray) -> None:
    """Write ``[n, 3, 3]`` float triangles as a binary STL."""
    tris = np.asarray(triangles, np.float32)
    n = tris.shape[0]
    normals = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(lens, 1e-12)
    rec = np.zeros(n, dtype=np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                      ("attr", "<u2")]))
    rec["n"] = normals
    rec["v"] = tris
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(np.uint32(n).tobytes())
        f.write(rec.tobytes())


def box_mesh(extents: Tuple[float, float, float]) -> np.ndarray:
    """``[12, 3, 3]`` triangles of a box centred at the origin."""
    hx, hy, hz = (e / 2.0 for e in extents)
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5),  # x faces
             (0, 4, 5, 1), (2, 3, 7, 6),  # y faces
             (0, 2, 6, 4), (1, 5, 7, 3)]  # z faces
    tris = []
    for a, b, c, d in quads:
        tris.append([v[a], v[b], v[c]])
        tris.append([v[a], v[c], v[d]])
    return np.asarray(tris, np.float32)
