"""Forward-model protocol (port of ``sigsvgd_tpu/models/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..utils.spaces import Box

ParamsDict = Optional[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DynamicsModel:
    """Subclasses define ``observation_space``, ``action_space`` and ``step``."""

    dt: float = 0.05

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
