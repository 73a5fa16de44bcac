"""Kinematic skid-steer robot, Kozlowski–Pazderski model (port of
``sigsvgd_tpu/models/skid_steer.py``); uncertain {x_icr, wheel_radius,
axial_distance}. State ``[x, y, θ, v, ω]``, actions the right and left
wheel speeds in rot/s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.math import clip
from ..utils.spaces import Box
from .base import DynamicsModel, ParamsDict


@dataclasses.dataclass(frozen=True)
class SkidSteerModel(DynamicsModel):
    x_icr: float = 0.2
    wheel_radius: float = 0.0625
    axial_distance: float = 0.475
    min_wheel_speed: float = -0.5
    max_wheel_speed: float = 0.5
    uncertain_params: Tuple[str, ...] = ("x_icr", "wheel_radius", "axial_distance")

    @property
    def observation_space(self) -> Box:
        return Box.create(5)

    @property
    def action_space(self) -> Box:
        return Box.create(2, low=self.min_wheel_speed, high=self.max_wheel_speed)

    def step(self, states, actions, params: ParamsDict = None):
        x = states[..., 0:1]
        y = states[..., 1:2]
        theta = states[..., 2:3]
        x_icr = self.resolve_param(params, "x_icr", self.x_icr)
        wheel_r = self.resolve_param(params, "wheel_radius", self.wheel_radius)
        axial = self.resolve_param(params, "axial_distance", self.axial_distance)

        right = clip(actions[..., 0:1], self.min_wheel_speed, self.max_wheel_speed)
        left = clip(actions[..., 1:2], self.min_wheel_speed, self.max_wheel_speed)

        v = (right + left) * math.pi * wheel_r
        omega = (right - left) * 2.0 * math.pi * wheel_r / axial

        fwd = v * self.dt
        lat = -omega * x_icr * self.dt
        new_x = x + fwd * torch.cos(theta) - lat * torch.sin(theta)
        new_y = y + fwd * torch.sin(theta) + lat * torch.cos(theta)
        new_theta = theta + omega * self.dt

        ones = torch.ones_like(x)
        return torch.cat([new_x, new_y, new_theta, v * ones, omega * ones], dim=-1)
