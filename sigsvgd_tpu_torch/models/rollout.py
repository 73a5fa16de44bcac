"""Batched horizon rollouts (port of ``sigsvgd_tpu/models/rollout.py``).

JAX scans the horizon; here it is a Python loop that autograd differentiates
through.
"""
from __future__ import annotations

import torch

from .base import DynamicsModel, ParamsDict


def rollout(model: DynamicsModel, init_state: torch.Tensor,
            actions: torch.Tensor, params: ParamsDict = None) -> torch.Tensor:
    """``init_state [..., dim_s]``, ``actions [..., H, dim_a]`` (batch dims
    broadcast) → states ``[..., H+1, dim_s]`` including the initial state."""
    batch = torch.broadcast_shapes(init_state.shape[:-1], actions.shape[:-2])
    state = init_state.expand(batch + init_state.shape[-1:])
    acts = actions.expand(batch + actions.shape[-2:])
    states = [state]
    for t in range(acts.shape[-2]):
        state = model.step(state, acts[..., t, :], params)
        states.append(state)
    return torch.stack(states, dim=-2)
