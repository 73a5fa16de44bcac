"""Merwe-scaled unscented transform, the sigma-point rollouts of DISCO
(port of ``sigsvgd_tpu/utils/utf.py``).

Default ``alpha=1.0`` (λ = 0, bounded weights), as in the JAX package; the
sigma-point offsets are the columns of the lower Cholesky factor of
``(λ+n)·cov``, so the inverse transform recovers the covariance.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MerweScaledUTF:
    """Sigma-point transformer: ``2n+1`` points for an ``n``-dim distribution.
    The weights are CPU tensors; each method moves them to its input."""

    n: int
    alpha: float = 1.0
    beta: float = 2.0
    kappa: float = 0.0

    @property
    def pts(self) -> int:
        return 2 * self.n + 1

    @property
    def _lambda(self) -> float:
        return self.alpha ** 2 * (self.n + self.kappa) - self.n

    @property
    def loc_weights(self) -> torch.Tensor:
        lam, n = self._lambda, self.n
        w = torch.full((self.pts,), 0.5 / (n + lam), dtype=torch.float32)
        w[0] = lam / (n + lam)
        return w

    @property
    def cov_weights(self) -> torch.Tensor:
        lam, n = self._lambda, self.n
        w = torch.full((self.pts,), 0.5 / (n + lam), dtype=torch.float32)
        w[0] = lam / (n + lam) + (1.0 - self.alpha ** 2 + self.beta)
        return w

    def compute_sigma_points(self, mu: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
        """Sigma points of ``N(mu, cov)`` → ``[n, 2n+1]`` (columns are points)."""
        low = torch.linalg.cholesky((self._lambda + self.n) * cov)
        mu_col = mu.reshape(-1, 1)
        return torch.cat([mu_col, low + mu_col, -low + mu_col], dim=1)

    def unscented_transform(self, sigmas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mean, cov)`` of transformed sigma points ``[n, 2n+1]``, computed
        against the central point."""
        wl = self.loc_weights.to(sigmas)
        wc = self.cov_weights.to(sigmas)
        center = sigmas[:, 0:1]
        mu = center[:, 0] + (sigmas - center) @ wl
        resid = sigmas - mu.reshape(-1, 1)
        cov = (resid * wc[None, :]) @ resid.T
        return mu, cov
