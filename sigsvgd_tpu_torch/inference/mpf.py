"""MPF, the Stein particle filter for online dynamics-parameter inference
(port of ``sigsvgd_tpu/inference/mpf.py``).

Particles are dynamics-parameter hypotheses θ. After every real transition
the posterior ``p(θ | obs) ∝ N(obs; f(s, a, θ), σ²I) · GMM-prior(θ)`` is
refined by ``n_steps`` SVGD steps with the velocity ``(K s − ∇K)/n``, then
the GMM prior is rebuilt around the moved particles. The score is autograd
through the likelihood's model step, on a fresh leaf each step, so no graph
outlives its step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.rbf import GaussianKernel
from ..utils.math import bw_silverman, gmm_log_prob
from .likelihoods import GaussianLikelihood, GaussianObs


class MPFState(NamedTuple):
    particles: torch.Tensor  # [k, p] parameter hypotheses (maybe log-space)
    prior_means: torch.Tensor  # [k, p] GMM component means (last update's particles)
    prior_bw: torch.Tensor  # scalar component std
    cond: GaussianObs


@dataclasses.dataclass(frozen=True)
class MPF:
    likelihood: GaussianLikelihood
    kernel: GaussianKernel = dataclasses.field(default_factory=GaussianKernel)
    lr: float = 0.01
    bw: Optional[float] = None  # fixed kernel/prior bandwidth; None = Silverman
    bw_scale: float = 1.0

    def _bandwidth(self, particles: torch.Tensor) -> torch.Tensor:
        if self.bw is not None:
            return torch.tensor(self.bw * self.bw_scale, dtype=particles.dtype,
                                device=particles.device)
        return torch.mean(bw_silverman(particles, self.bw_scale))

    def init(self, particles: torch.Tensor, initial_obs: torch.Tensor) -> MPFState:
        """Initialize from prior samples and the first observation."""
        cond = GaussianObs(
            past_obs=initial_obs,
            past_action=torch.zeros((0,), dtype=particles.dtype, device=particles.device),
            obs=initial_obs,
        )
        return MPFState(particles=particles, prior_means=particles,
                        prior_bw=self._bandwidth(particles), cond=cond)

    def prior_log_prob(self, state: MPFState, theta: torch.Tensor) -> torch.Tensor:
        return gmm_log_prob(
            theta, state.prior_means, state.prior_bw**2,
            torch.ones((state.prior_means.shape[0],), dtype=theta.dtype,
                       device=theta.device),
        )

    def _score(self, x: torch.Tensor, state: MPFState) -> torch.Tensor:
        """``∇_θ log p(θ | obs)`` at each particle, by autograd through the
        likelihood's model step on a fresh leaf."""
        with torch.enable_grad():
            theta = x.detach().requires_grad_(True)
            pred = self.likelihood.sample(theta, state.cond)
            log_lik = torch.sum(self.likelihood.log_prob(pred, state.cond))
            log_pri = torch.sum(self.prior_log_prob(state, theta))
            (score,) = torch.autograd.grad(log_lik + log_pri, theta)
        return score

    def _phi(self, x: torch.Tensor, state: MPFState, bw: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        score = self._score(x, state)
        k_xx, grad_k = self.kernel(x, x, h=bw)
        return (k_xx @ score.reshape(n, -1) - grad_k).reshape(x.shape) / n

    @torch.no_grad()
    def observe(self, state: MPFState, action: torch.Tensor, new_obs: torch.Tensor,
                n_steps: int = 20, bw: Optional[float] = None
                ) -> Tuple[MPFState, torch.Tensor]:
        """Condition on a real transition and run ``n_steps`` Stein updates.
        Returns the new filter state and the per-step norms of φ."""
        cond = self.likelihood.condition(action, new_obs, prev=state.cond)
        state = state._replace(cond=cond)
        kern_bw = (
            torch.tensor(bw * self.bw_scale, dtype=state.particles.dtype,
                         device=state.particles.device)
            if bw is not None
            else self._bandwidth(state.particles)
        )
        x, norms = state.particles, []
        for _ in range(n_steps):
            phi = self._phi(x, state, kern_bw)
            x = x + self.lr * phi
            norms.append(torch.linalg.vector_norm(phi))
        new_state = MPFState(particles=x, prior_means=x, prior_bw=kern_bw, cond=cond)
        return new_state, torch.stack(norms)
