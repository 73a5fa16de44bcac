"""2-D point-mass particle in an obstacle maze (port of
``sigsvgd_tpu/models/particle.py``): Euler integration with velocity or
acceleration control, optional control-channel noise, crash-on-collision
freezing against an occupancy grid, and the quadratic + obstacle costs the
maze uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .._device import resolve_device
from ..utils import obstacle_map as om
from ..utils.math import clip
from ..utils.spaces import Box
from .base import DynamicsModel, ParamsDict

_INF = float("inf")


@dataclasses.dataclass(frozen=True, eq=False)
class ParticleModel(DynamicsModel):
    mass: float = 1.0
    control_type: str = "acceleration"  # or "velocity"
    max_speed: float = _INF
    max_accel: float = _INF
    noise_std: Tuple[float, float] = (0.0, 0.0)
    deterministic: bool = True
    can_crash: bool = False
    obstacle_map: Optional[om.ObstacleMap] = None
    init_state: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_state: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    cost_params: Tuple[Tuple[str, float], ...] = (
        ("w_qpos", 1.0),
        ("w_qvel", 1.0),
        ("w_qpos_T", 1.0),
        ("w_qvel_T", 1.0),
        ("w_ctrl", 1.0),
        ("w_obs", 1.0),
    )
    uncertain_params: Tuple[str, ...] = ("mass",)
    device: Optional[torch.device] = None  # None means "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        # the cost weights live on the device once, not per call; a
        # velocity-controlled state has no velocity part
        has_vel = self.control_type != "velocity"
        for name, (wp, wv) in (("_w_state", ("w_qpos", "w_qvel")),
                               ("_w_term", ("w_qpos_T", "w_qvel_T"))):
            w = [self._w(wp)] * 2 + ([self._w(wv)] * 2 if has_vel else [])
            object.__setattr__(self, name, torch.tensor(w, dtype=torch.float32,
                                                        device=self.device))
        object.__setattr__(self, "_target", torch.tensor(
            self.target_state, dtype=torch.float32, device=self.device))

    @staticmethod
    def create(
        *,
        dt: float = 0.05,
        mass: float = 1.0,
        control_type: str = "acceleration",
        max_speed: Optional[float] = None,
        max_accel: Optional[float] = None,
        noise_std=(0.0, 0.0),
        deterministic: bool = True,
        can_crash: bool = False,
        with_obstacle: bool = False,
        obst_preset: Optional[str] = None,
        obst_width: float = 2.0,
        map_size: Tuple[int, int] = (10, 10),
        map_cell_size: float = 0.1,
        init_state=(0.0, 0.0, 0.0, 0.0),
        target_state=(0.0, 0.0, 0.0, 0.0),
        cost_params: Optional[Dict[str, float]] = None,
        uncertain_params: Tuple[str, ...] = ("mass",),
        device=None,
    ) -> "ParticleModel":
        device = resolve_device(device)
        omap = None
        if with_obstacle:
            obstacles = om.obstacle_preset(obst_preset, obst_width) if obst_preset else []
            omap = om.generate_obstacle_map(map_size, obstacles, map_cell_size,
                                            device=device)
        cp = {
            "w_qpos": 1.0, "w_qvel": 1.0, "w_qpos_T": 1.0,
            "w_qvel_T": 1.0, "w_ctrl": 1.0, "w_obs": 1.0,
        }
        if cost_params:
            cp.update(cost_params)
        return ParticleModel(
            dt=dt,
            mass=mass,
            control_type=control_type,
            max_speed=_INF if max_speed is None else float(max_speed),
            max_accel=_INF if max_accel is None else float(max_accel),
            noise_std=tuple(float(s) for s in noise_std),
            deterministic=deterministic,
            can_crash=can_crash,
            obstacle_map=omap,
            init_state=tuple(float(v) for v in init_state),
            target_state=tuple(float(v) for v in target_state),
            cost_params=tuple(sorted(cp.items())),
            uncertain_params=uncertain_params,
            device=device,
        )

    # -- spaces -----------------------------------------------------------
    @property
    def observation_space(self) -> Box:
        if self.control_type == "velocity":
            return Box.create(2)
        return Box.create(4, low=[-_INF, -_INF, -self.max_speed, -self.max_speed],
                          high=[_INF, _INF, self.max_speed, self.max_speed])

    @property
    def action_space(self) -> Box:
        bound = self.max_speed if self.control_type == "velocity" else self.max_accel
        return Box.create(2, low=-bound, high=bound)

    @property
    def target(self) -> torch.Tensor:
        return self._target

    def _w(self, name: str) -> float:
        return dict(self.cost_params)[name]

    # -- dynamics ----------------------------------------------------------
    def step(self, states, actions, params: ParamsDict = None,
             generator: Optional[torch.Generator] = None):
        """One Euler step; a stochastic model adds control noise drawn from
        ``generator`` (none without one, as JAX without a key)."""
        m = self.resolve_param(params, "mass", self.mass)
        acts = actions
        if not self.deterministic and generator is not None:
            noise = torch.randn(acts.shape, generator=generator, dtype=acts.dtype,
                                device=acts.device)
            acts = acts + torch.tensor(self.noise_std, dtype=acts.dtype,
                                       device=acts.device) * noise
        if self.control_type == "acceleration":
            acts = clip(acts / m, -self.max_accel, self.max_accel)
            x_dot = torch.cat([states[..., 2:], acts], dim=-1)
        else:
            x_dot = clip(acts, -self.max_speed, self.max_speed)
        if self.can_crash and self.obstacle_map is not None:
            # crashed particles freeze in place
            collided = om.get_collisions(self.obstacle_map, states[..., 0:2])
            next_states = states + x_dot * self.dt * (1.0 - collided[..., None])
        else:
            next_states = states + x_dot * self.dt
        # the last two state dims are clamped to max_speed whatever the
        # control type (in velocity mode that is the position), as in JAX
        clamped = clip(next_states[..., -2:], -self.max_speed, self.max_speed)
        return torch.cat([next_states[..., :-2], clamped], dim=-1)

    # -- built-in costs ----------------------------------------------------
    def _obst_cost(self, states):
        if self.obstacle_map is None:
            return 0.0
        return self._w("w_obs") * om.get_collisions(self.obstacle_map, states[..., 0:2])

    def default_inst_cost(self, states, actions=None, **_):
        obst_cost = self._obst_cost(states)
        delta = states - self._target
        state_cost = torch.sum(delta * delta * self._w_state, dim=-1)
        ctrl_cost = 0.0
        if actions is not None:
            ctrl_cost = self._w("w_ctrl") * torch.sum(actions * actions, dim=-1)
        return state_cost + ctrl_cost + obst_cost

    def default_term_cost(self, states, **_):
        obst_cost = self._obst_cost(states)
        delta = states - self._target
        return torch.sum(delta * delta * self._w_term, dim=-1) + obst_cost
