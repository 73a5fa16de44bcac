"""Analytic 2-D target densities for SVGD checks (port of
``sigsvgd_tpu/models/toy.py``): the double banana, the sine and the star
Gaussian, each with ``logp``, its gradient (autograd) and, for the double
banana, its per-point Hessian (double backward).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .._device import resolve_device


def _grad_sum(fn, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xx).sum(), xx)
    return g


@dataclasses.dataclass(frozen=True)
class DoubleBanana:
    """Rosenbrock-warped likelihood ``F(x) = log((a-x₁)² + b(x₂-x₁²)²)`` with
    a Gaussian prior and the observation ``y``."""

    a: float = 1.0
    b: float = 100.0
    prior_var: float = 1.0
    y_var: float = 0.09
    y: float = math.log(30.0)

    def f(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[..., 0], x[..., 1]
        return torch.log((self.a - x1) ** 2 + self.b * (x2 - x1 ** 2) ** 2 + 1e-10)

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        fx = self.f(x)
        return (-torch.sum(x * x, dim=-1) / (2.0 * self.prior_var)
                - (fx - self.y) ** 2 / (2.0 * self.y_var))

    def grad_log_p(self, x: torch.Tensor) -> torch.Tensor:
        return _grad_sum(self.logp, x)

    def hessian_log_p(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, 2, 2]`` Hessians of ``logp`` at the points ``x [n, 2]``
        (each point's ``logp`` depends on that point alone, so the rows of
        every Hessian come from one double backward each)."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.logp(xx).sum(), xx, create_graph=True)
            rows = [torch.autograd.grad(g[..., i].sum(), xx, retain_graph=True)[0]
                    for i in range(x.shape[-1])]
        return torch.stack(rows, dim=-2)


@dataclasses.dataclass(frozen=True)
class Sine:
    """``F(x) = (x₂ + sin x₁)²`` likelihood with a Gaussian prior."""

    prior_var: float = 1.0
    y_var: float = 0.09

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        fx = (x[..., 1] + torch.sin(x[..., 0])) ** 2
        return -torch.sum(x * x, dim=-1) / (2.0 * self.prior_var) - fx ** 2 / (2.0 * self.y_var)

    def grad_log_p(self, x: torch.Tensor) -> torch.Tensor:
        return _grad_sum(self.logp, x)


def star_gaussian(skewness: float = 100.0, n_components: int = 5,
                  device=None) -> "StarGaussian":
    """A ring of ``n_components`` anisotropic Gaussians, each the last one
    rotated by 2π/n, built on the CPU in fp32 and placed on ``device`` (the
    card unless the CPU is asked for)."""
    device = resolve_device(device)
    theta = torch.tensor(2.0 * math.pi / n_components, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    u = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
    mus = [torch.tensor([1.5, 0.0])]
    sigmas = [torch.diag(torch.tensor([1.0, 1.0 / skewness]))]
    for _ in range(1, n_components):
        mus.append(u @ mus[-1])
        sigmas.append(u @ sigmas[-1] @ u.T)
    return StarGaussian(mus=torch.stack(mus).to(device), sigmas=torch.stack(sigmas).to(device))


class StarGaussian:
    """An equal-weight mixture of Gaussians ``N(mus[k], sigmas[k])``."""

    def __init__(self, mus: torch.Tensor, sigmas: torch.Tensor):
        self.mus = mus  # [k, 2]
        self.sigmas = sigmas  # [k, 2, 2]

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        diff = x[None] - self.mus.reshape((-1,) + (1,) * (x.ndim - 1) + (2,))
        prec = torch.linalg.inv(self.sigmas)
        quad = -0.5 * torch.einsum("k...i,kij,k...j->k...", diff, prec, diff)
        logdet = torch.linalg.slogdet(self.sigmas)[1]
        logdet = logdet.reshape((-1,) + (1,) * (x.ndim - 1))
        comp = quad - 0.5 * (logdet + 2.0 * math.log(2.0 * math.pi))
        return torch.logsumexp(comp, dim=0) - math.log(self.mus.shape[0])

    def grad_log_p(self, x: torch.Tensor) -> torch.Tensor:
        return _grad_sum(self.logp, x)

    def sample(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``n`` draws, component then normal, from ``generator`` on the
        mixture's device."""
        k = self.mus.shape[0]
        dev = self.mus.device
        comps = torch.randint(0, k, (n,), generator=generator, device=dev)
        chols = torch.linalg.cholesky(self.sigmas)
        eps = torch.randn((n, 2), generator=generator, device=dev)
        return self.mus[comps] + torch.einsum("nij,nj->ni", chols[comps], eps)
