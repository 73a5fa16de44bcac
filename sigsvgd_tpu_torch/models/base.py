"""Forward-model protocol and uncertain-parameter plumbing (port of
``sigsvgd_tpu/models/base.py``).

Uncertain parameters travel as a dict ``{name: [k, 1]}`` built from a
``[k, p]`` sample matrix, so one ``step`` evaluates k parameter hypotheses
against k (batched) states by broadcasting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..utils.spaces import Box

ParamsDict = Optional[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DynamicsModel:
    """Subclasses define ``observation_space``, ``action_space``, ``step``
    and the ordered ``uncertain_params`` tuple."""

    dt: float = 0.05
    uncertain_params: Tuple[str, ...] = ()

    @property
    def observation_space(self) -> Box:
        raise NotImplementedError

    @property
    def action_space(self) -> Box:
        raise NotImplementedError

    def step(self, states: torch.Tensor, actions: torch.Tensor,
             params: ParamsDict = None) -> torch.Tensor:
        raise NotImplementedError

    @property
    def dim_s(self) -> int:
        return self.observation_space.dim

    @property
    def dim_a(self) -> int:
        return self.action_space.dim

    def params_to_dict(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[k, p]`` sample matrix → ``{name: [k, 1]}`` broadcastable columns."""
        params = torch.atleast_2d(params)
        return {name: params[:, i].reshape(-1, 1)
                for i, name in enumerate(self.uncertain_params)}

    def dict_to_params(self, params_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([torch.atleast_2d(params_dict[name])
                          for name in self.uncertain_params], dim=-1)

    def resolve_param(self, params: ParamsDict, name: str, default: float):
        """The sampled value if ``params`` has it, else the model default."""
        if params is not None and name in params:
            return params[name]
        return default
