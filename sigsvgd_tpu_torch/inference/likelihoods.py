"""Likelihood models bridging costs and observations to log-probabilities
(port of ``sigsvgd_tpu/inference/likelihoods.py``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ExponentiatedUtility:
    """``log p(cost) = -cost / α``, shifted by the batch's minimum when more
    than one cost is given."""

    alpha: float = 1.0

    def log_p(self, costs: torch.Tensor) -> torch.Tensor:
        costs = torch.atleast_1d(costs)
        shifted = costs - torch.min(costs) if costs.numel() > 1 else costs
        return -shifted / self.alpha


class GaussianObs(NamedTuple):
    """Conditioning state of the Gaussian observation likelihood: the last
    real observation and action."""

    past_obs: torch.Tensor
    past_action: torch.Tensor
    obs: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood:
    """Observation model ``N(new_obs; step_fn(past_obs, action, θ), σ²I)``
    over dynamics parameters θ, the MPF's measurement model.
    ``params_to_dict`` maps a ``[k, p]`` parameter matrix to the model's
    parameter dict."""

    step_fn: Callable[..., torch.Tensor]
    params_to_dict: Callable[[torch.Tensor], Any]
    obs_std: float
    log_space: bool = False

    def condition(self, action: torch.Tensor, new_obs: torch.Tensor,
                  prev: GaussianObs = None) -> GaussianObs:
        past = prev.obs if prev is not None else new_obs
        return GaussianObs(past_obs=past, past_action=action, obs=new_obs)

    def sample(self, theta: torch.Tensor, cond: GaussianObs) -> torch.Tensor:
        """Predicted next observation per particle θ (``[k, p] -> [k, obs]``)."""
        params = torch.exp(theta) if self.log_space else theta
        k = theta.shape[0]
        states = cond.past_obs.expand((k,) + tuple(cond.past_obs.shape))
        actions = cond.past_action.expand((k,) + tuple(cond.past_action.shape))
        return self.step_fn(states, actions, self.params_to_dict(params))

    def log_prob(self, samples: torch.Tensor, cond: GaussianObs) -> torch.Tensor:
        """``[k, obs] -> [k]`` Gaussian log-density of the real observation."""
        d = cond.obs.shape[-1]
        var = self.obs_std**2
        diff = samples - cond.obs
        return -0.5 * torch.sum(diff * diff, dim=-1) / var - 0.5 * d * math.log(
            2.0 * math.pi * var
        )
