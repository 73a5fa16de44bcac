"""Exact collision audit of planned trajectories (port of
``sigsvgd_tpu/experiments/verify_trajectory.py``): knot particles are
expanded to their splines and replayed against the exact scene SDF (hard
occupancy, not the learned or soft cost) and the exact capsule
self-collision oracle, counting the colliding waypoints."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.robot.panda import PandaRobot
from ..models.robot.scene import Scene, scene_occupancy
from ..models.robot.self_collision import self_collision
from ..utils.splines import spline_trajectory
from .planning import create_body_points


def verify_knot_trajectories(robot: PandaRobot, scene: Scene, q_start: torch.Tensor,
                             q_target: torch.Tensor, knots: torch.Tensor,
                             timesteps: int = 200, n_body_points: int = 10,
                             margin: float = 0.0) -> Dict[str, np.ndarray]:
    """Audit of knot particles ``[batch, n_free, dof]``: each particle's
    fraction of waypoints in scene and in self collision, whether it is
    collision free, and how many are."""
    batch, dof = knots.shape[0], knots.shape[-1]
    with torch.no_grad():
        full = torch.cat([q_start.expand(batch, 1, dof), knots,
                          q_target.expand(batch, 1, dof)], dim=1)
        qs = spline_trajectory(full, timesteps)  # [batch, T, dof]
        body = create_body_points(robot.qs_to_joints_xs(qs), n_body_points)
        env_hit = torch.amax(scene_occupancy(scene, body, margin), dim=-1)  # [batch, T]
        self_hit = self_collision(robot, qs)  # [batch, T]
        valid = ((torch.amax(env_hit, dim=-1) == 0)
                 & (torch.amax(self_hit, dim=-1) == 0)).cpu().numpy()
        return {
            "env_collision_fraction": env_hit.mean(-1).cpu().numpy(),
            "self_collision_fraction": self_hit.mean(-1).cpu().numpy(),
            "collision_free": valid,
            "n_valid": int(valid.sum()),
        }
