"""Continuous-force cartpole with friction, Barto–Sutton–Anderson equations
(port of ``sigsvgd_tpu/models/cartpole.py``); uncertain {g, mass_cart,
mass_pole, length, mu_c, mu_p, f_mag}. The total mass is ``m_c + m_p``;
``reference_mass_bug=True`` takes the reference's ``m_c + m_c``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.math import clip
from ..utils.spaces import Box
from .base import DynamicsModel, ParamsDict

_THETA_LIMIT = 12 * 2 * math.pi / 360
_X_LIMIT = 2.4


@dataclasses.dataclass(frozen=True)
class CartPoleModel(DynamicsModel):
    g: float = 9.8
    f_mag: float = 10.0
    mass_cart: float = 1.0
    mass_pole: float = 0.1
    length: float = 1.0
    mu_c: float = 0.5e-3
    mu_p: float = 2e-6
    reference_mass_bug: bool = False
    uncertain_params: Tuple[str, ...] = (
        "g",
        "mass_cart",
        "mass_pole",
        "length",
        "mu_c",
        "mu_p",
        "f_mag",
    )

    @property
    def observation_space(self) -> Box:
        high = [2 * _X_LIMIT, float("inf"), 2 * float(_THETA_LIMIT), float("inf")]
        return Box.create(4, low=[-h for h in high], high=high)

    @property
    def action_space(self) -> Box:
        return Box.create(1, low=-1.0, high=1.0)

    def step(self, states, actions, params: ParamsDict = None):
        x_d = states[..., 1:2]
        theta = states[..., 2:3]
        theta_d = states[..., 3:4]
        g = self.resolve_param(params, "g", self.g)
        m_c = self.resolve_param(params, "mass_cart", self.mass_cart)
        m_p = self.resolve_param(params, "mass_pole", self.mass_pole)
        length = self.resolve_param(params, "length", self.length)
        mu_c = self.resolve_param(params, "mu_c", self.mu_c)
        mu_p = self.resolve_param(params, "mu_p", self.mu_p)
        f_mag = self.resolve_param(params, "f_mag", self.f_mag)

        acts = clip(actions, -1.0, 1.0) * f_mag
        mass = (m_c + m_c) if self.reference_mass_bug else (m_c + m_p)
        pole_mass = m_p * length
        cart_friction = mu_c * torch.sign(x_d)
        pole_friction = (mu_p * theta_d) / pole_mass
        factor = (acts + pole_mass * torch.sin(theta) * theta_d**2 - cart_friction) / mass
        tdd_num = g * torch.sin(theta) - torch.cos(theta) * factor - pole_friction
        tdd_den = length * (4.0 / 3.0 - (m_p * torch.cos(theta) ** 2) / mass)
        theta_dd = tdd_num / tdd_den
        x_dd = factor - pole_mass * theta_dd * torch.cos(theta) / mass

        delta = torch.cat([x_d, x_dd, theta_d, theta_dd], dim=-1) * self.dt
        return states + delta

    def balance_inst_cost(self, states, actions=None, **_):
        """Quadratic keep-upright cost."""
        cost = (
            states[..., 0] ** 2
            + 0.1 * states[..., 1] ** 2
            + 10.0 * states[..., 2] ** 2
            + 0.1 * states[..., 3] ** 2
        )
        if actions is not None:
            cost = cost + 0.001 * torch.sum(actions * actions, dim=-1)
        return cost

    def balance_term_cost(self, states, **_):
        return self.balance_inst_cost(states)
