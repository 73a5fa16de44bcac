"""Occupancy-grid obstacle maps for the 2-D particle environments (port of
``sigsvgd_tpu/utils/obstacle_map.py``).

The grid is rasterised once on the host in numpy, exactly as the JAX
package does (its own copy here, cell for cell), and then moved to the
device; the collision lookup is a clamped gather on the device.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device


class ObstacleMap(NamedTuple):
    """Static occupancy grid. ``grid[ix, iy] ∈ {0, 1}``; world origin at center."""

    grid: torch.Tensor  # [nx, ny] float32
    cell_size: float
    offset: Tuple[int, int]  # origin cell indices (center of the map)

    @property
    def xlim(self) -> Tuple[float, float]:
        half = self.cell_size * self.grid.shape[0] / 2.0
        return (-half, half)

    @property
    def ylim(self) -> Tuple[float, float]:
        half = self.cell_size * self.grid.shape[1] / 2.0
        return (-half, half)


def _cell_coords(omap: ObstacleMap, xy: torch.Tensor) -> torch.Tensor:
    """``xy / cell_size + offset`` as the JAX package computes it under
    ``jit``: XLA folds the division into a product by the fp32 reciprocal of
    the cell size and fuses it with the sum into one multiply-add. In fp64
    that product and sum are exact for fp32 inputs, so rounding them once to
    fp32 gives the multiply-add's result, on the CPU and on the card alike,
    and ``floor`` sees the same number at a cell edge."""
    inv = float(np.float32(1.0) / np.float32(omap.cell_size))
    u = xy.detach().double() * inv
    return [(u[..., i] + float(omap.offset[i])).to(xy.dtype) for i in range(2)]


def get_collisions(omap: ObstacleMap, xy: torch.Tensor) -> torch.Tensor:
    """Occupancy value at world positions ``xy [..., 2]`` → ``[...]``.

    Out-of-bounds queries clamp to the border cells (which the generator fills
    with walls). The lookup carries no gradient, as ``floor``'s in JAX."""
    grid = omap.grid
    cx, cy = _cell_coords(omap, xy)
    ix = torch.floor(cx).to(torch.int64).clamp(0, grid.shape[0] - 1)
    iy = torch.floor(cy).to(torch.int64).clamp(0, grid.shape[1] - 1)
    return grid[ix, iy]


def to_map_coord(omap: ObstacleMap, xy: torch.Tensor) -> torch.Tensor:
    """World position → fractional cell coordinates (for plotting)."""
    return torch.stack(_cell_coords(omap, xy), dim=-1)


# ---------------------------------------------------------------------------
# Host-side map construction (numpy, as in the JAX package).
# ---------------------------------------------------------------------------


def _add_rect(grid: np.ndarray, cell_size: float, offset, cx, cy, w, h) -> None:
    """Rasterize an axis-aligned rectangle (center, width, height) in place,
    with the reference's quirks: centers are ``int()``-truncated, cell
    extents ``ceil``-rounded, and the raw python slice is used, so a
    rectangle whose start index is negative rasterizes nothing."""
    cx, cy = int(cx), int(cy)
    wc = math.ceil(w / cell_size)
    hc = math.ceil(h / cell_size)
    cxc = math.ceil(cx / cell_size)
    cyc = math.ceil(cy / cell_size)
    x0 = cxc - math.ceil(wc / 2.0) + offset[0]
    x1 = cxc + math.ceil(wc / 2.0) + offset[0]
    y0 = cyc - math.ceil(hc / 2.0) + offset[1]
    y1 = cyc + math.ceil(hc / 2.0) + offset[1]
    grid[x0:x1, y0:y1] = 1.0


def obstacle_preset(name: str, width: float = 2.0) -> List[Tuple[float, float, float, float]]:
    """Named obstacle layouts ``[(cx, cy, w, h), ...]``: regular ``k×k``
    grids with spacing ``s`` and staggered rows."""
    w = width

    def grid_layout(k: int, s: float):
        coords = [s * (i - (k - 1) / 2.0) for i in range(k)]
        return [(x, y, w, w) for y in reversed(coords) for x in coords]

    def staggered(rows: Sequence[Tuple[int, float, float]], s: float):
        out = []
        for count, y, x_off in rows:
            xs = [s * (i - (count - 1) / 2.0) + x_off for i in range(count)]
            out.extend((x, y, w, w) for x in xs)
        return out

    if name == "grid_3x3":
        return grid_layout(3, 5.0)
    if name == "grid_4x4":
        return grid_layout(4, 4.0)
    if name == "sm_grid_4x4":
        return grid_layout(4, 1.0)
    if name == "grid_6x6":
        return grid_layout(6, 3.0)
    if name == "staggered_3-2-3":
        return staggered([(3, 4.0, 0.0), (4, 0.0, 0.0), (3, -4.0, 0.0)], 4.0)
    if name == "staggered_4-3-4-3-4":
        return staggered(
            [(4, 6.0, 0.0), (3, 3.0, 0.0), (4, 0.0, 0.0), (3, -3.0, 0.0), (4, -6.0, 0.0)],
            4.0,
        )
    if name == "single_centred":
        return [(0.0, 0.0, w, w)]
    raise ValueError(f"Unknown obstacle preset: {name}")


def generate_obstacle_map(
    map_size: Tuple[int, int],
    obstacles: Sequence[Tuple[float, float, float, float]],
    cell_size: float,
    *,
    with_borders: bool = True,
    rng: Optional[np.random.Generator] = None,
    num_random: int = 0,
    random_xy_limits=None,
    random_shape: Tuple[float, float] = (2.0, 2.0),
    device=None,
) -> ObstacleMap:
    """Build an :class:`ObstacleMap` from fixed rectangles (+ optional random
    ones drawn from ``rng``) on ``device`` (None means the card).

    ``map_size`` is the world extent (must be even, origin-centered); border
    walls of width ``4*cell_size`` are added on every side."""
    assert map_size[0] % 2 == 0 and map_size[1] % 2 == 0, "map size must be even"
    nx = math.ceil(map_size[0] / cell_size)
    ny = math.ceil(map_size[1] / cell_size)
    offset = (nx // 2, ny // 2)
    grid = np.zeros((nx, ny), dtype=np.float32)

    for cx, cy, w, h in obstacles:
        _add_rect(grid, cell_size, offset, cx, cy, w, h)

    if with_borders:
        half_x = cell_size * nx / 2.0
        half_y = cell_size * ny / 2.0
        for xl in (-half_x, half_x):
            _add_rect(grid, cell_size, offset, xl, 0.0, 4 * cell_size, 2 * half_y)
        for yl in (-half_y, half_y):
            _add_rect(grid, cell_size, offset, 0.0, yl, 2 * half_x, 4 * cell_size)

    if num_random > 0:
        if rng is None:
            raise ValueError("random obstacles need a numpy Generator (rng)")
        xlim, ylim = random_xy_limits or ((-map_size[0] / 2, map_size[0] / 2),) * 2
        placed = 0
        attempts = 0
        while placed < num_random and attempts < 25 * num_random:
            cx = rng.uniform(*xlim)
            cy = rng.uniform(*ylim)
            # the candidate alone, so its overlap with the grid shows
            candidate = np.zeros_like(grid)
            _add_rect(candidate, cell_size, offset, cx, cy, *random_shape)
            attempts += 1
            if not np.any((candidate > 0) & (grid > 0)):
                grid = np.maximum(grid, candidate)
                placed += 1

    return ObstacleMap(torch.from_numpy(grid).to(resolve_device(device)),
                       float(cell_size), offset)
