"""Body points and exact-SDF occupancy (the part of
``sigsvgd_tpu/experiments/planning.py`` the MPC cost uses; the planner itself
waits for ROADMAP queue 1, M10)."""
from __future__ import annotations

import torch

from ..models.robot.scene import Scene, scene_sdf


def create_body_points(xs: torch.Tensor, n_pts: int = 10) -> torch.Tensor:
    """Interpolate points along each arm segment:
    ``[..., L, 3] → [..., (L-1)*n_pts, 3]``."""
    frac = torch.linspace(0.0, 1.0, n_pts + 1, dtype=xs.dtype,
                          device=xs.device)[:-1]
    seg0 = xs[..., :-1, None, :]
    seg1 = xs[..., 1:, None, :]
    pts = seg0 + frac[:, None] * (seg1 - seg0)
    return pts.reshape(xs.shape[:-2] + (-1, 3))


def sdf_occupancy(scene: Scene, sharpness: float = 50.0):
    """Exact-SDF soft occupancy ``sigmoid(-sharpness·sdf)``."""

    def occ(x):
        return torch.sigmoid(-sharpness * scene_sdf(scene, x))

    return occ
