"""1-DoF inverted pendulum, Gym Pendulum-v0 dynamics (port of
``sigsvgd_tpu/models/pendulum.py``): uncertain {g, mass, length}; torque
clamped to ±2, angular velocity to ±8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.math import clip
from ..utils.spaces import Box
from .base import DynamicsModel, ParamsDict

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0


@dataclasses.dataclass(frozen=True)
class PendulumModel(DynamicsModel):
    g: float = 9.8
    mass: float = 1.0
    length: float = 1.0
    uncertain_params: Tuple[str, ...] = ("g", "mass", "length")

    @property
    def observation_space(self) -> Box:
        return Box.create(2, low=[-float("inf"), -_MAX_SPEED], high=[float("inf"), _MAX_SPEED])

    @property
    def action_space(self) -> Box:
        return Box.create(1, low=-_MAX_TORQUE, high=_MAX_TORQUE)

    def step(self, states, actions, params: ParamsDict = None):
        theta = states[..., 0:1]
        theta_d = states[..., 1:2]
        g = self.resolve_param(params, "g", self.g)
        m = self.resolve_param(params, "mass", self.mass)
        length = self.resolve_param(params, "length", self.length)

        acts = clip(actions, -_MAX_TORQUE, _MAX_TORQUE)
        theta_dd = (
            -3.0 * g / (2.0 * length) * torch.sin(theta + math.pi)
            + 3.0 / (m * length**2) * acts
        )
        theta_d = clip(theta_d + self.dt * theta_dd, -_MAX_SPEED, _MAX_SPEED)
        theta = theta + theta_d * self.dt  # semi-implicit: new velocity first
        return torch.cat([theta, theta_d], dim=-1)

    @staticmethod
    def get_obs(states: torch.Tensor) -> torch.Tensor:
        """``[θ, θ̇] → [cos θ, sin θ, θ̇]`` (Gym observation convention)."""
        theta = states[..., 0:1]
        theta_d = states[..., 1:2]
        return torch.cat([torch.cos(theta), torch.sin(theta), theta_d], dim=-1)

    @staticmethod
    def _wrapped_angle_cost(states):
        theta = torch.remainder(states[..., 0] + math.pi, 2.0 * math.pi) - math.pi
        return theta**2 + 0.1 * states[..., 1] ** 2

    def swingup_inst_cost(self, states, actions=None, **_):
        """Standard swing-up cost: ``θ² + 0.1 θ̇² + 0.001 u²`` with the angle
        wrapped to (-π, π]."""
        cost = self._wrapped_angle_cost(states)
        if actions is not None:
            cost = cost + 0.001 * torch.sum(actions * actions, dim=-1)
        return cost

    def swingup_term_cost(self, states, **_):
        return self._wrapped_angle_cost(states)
