"""Distributions as small tuples with free functions (port of
``sigsvgd_tpu/utils/distributions.py``): the DuSt policy prior, and the
uncertain dynamics parameters that ``DuSt.forward`` samples.

Every draw comes from an explicit ``torch.Generator``, or is given: each
sampler takes its standard normals (``eps``) and, for a mixture, its
components (``comps``) in place of drawing them. With neither, a draw
raises ``ValueError``: no default generator is used.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .math import clip, gmm_log_prob


class Gaussian(NamedTuple):
    """Multivariate normal; ``cov`` may be ``[p, p]`` or diagonal ``[p]``."""

    mean: torch.Tensor
    cov: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]


class ParticleGMM(NamedTuple):
    """Equal-bandwidth mixture over particles (the DuSt policy prior)."""

    means: torch.Tensor  # [k, p]
    var: torch.Tensor  # scalar or [p]
    weights: torch.Tensor  # [k]


Distribution = Union[Gaussian, ParticleGMM]


def _need(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} needs a torch.Generator or the draws given")
    return generator


def standard_normal(shape: Tuple[int, ...], like: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``eps`` if given (checked against ``shape``), else standard normals
    of ``like``'s dtype and device drawn from ``generator``."""
    if eps is not None:
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"given draws have shape {tuple(eps.shape)}, "
                             f"expected {tuple(shape)}")
        return eps.to(device=like.device, dtype=like.dtype)
    return torch.randn(shape, generator=_need(generator, "a normal draw"),
                       dtype=like.dtype, device=like.device)


def _categorical(weights: torch.Tensor, shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                comps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``comps`` if given, else indices drawn in proportion to ``weights``."""
    if comps is not None:
        if tuple(comps.shape) != tuple(shape):
            raise ValueError(f"given components have shape {tuple(comps.shape)}, "
                             f"expected {tuple(shape)}")
        return comps.to(device=weights.device, dtype=torch.long)
    n = math.prod(shape)
    idx = torch.multinomial(weights, n, replacement=True,
                            generator=_need(generator, "a mixture draw"))
    return idx.reshape(shape)


def sample(dist: Distribution, shape: Tuple[int, ...],
           generator: Optional[torch.Generator] = None, *,
           eps: Optional[torch.Tensor] = None,
           comps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shape`` samples of ``dist``. A mixture draws its components first,
    then the noise."""
    shape = tuple(shape)
    if isinstance(dist, Gaussian):
        e = standard_normal(shape + tuple(dist.mean.shape), dist.mean, generator, eps)
        if dist.cov.ndim == 2:
            chol = torch.linalg.cholesky(dist.cov)
            return dist.mean + e @ chol.T
        return dist.mean + e * torch.sqrt(dist.cov)
    if isinstance(dist, ParticleGMM):
        c = _categorical(dist.weights, shape, generator, comps)
        e = standard_normal(shape + tuple(dist.means.shape[-1:]), dist.means,
                            generator, eps)
        var = torch.as_tensor(dist.var, dtype=dist.means.dtype, device=dist.means.device)
        return dist.means[c] + e * torch.sqrt(var)
    raise TypeError(f"Unknown distribution type: {type(dist)}")


def log_prob(dist: Distribution, x: torch.Tensor) -> torch.Tensor:
    if isinstance(dist, Gaussian):
        diff = x - dist.mean
        if dist.cov.ndim == 2:
            sol = torch.linalg.solve(dist.cov, diff[..., None])[..., 0]
            quad = torch.sum(diff * sol, dim=-1)
            logdet = torch.linalg.slogdet(dist.cov)[1]
        else:
            quad = torch.sum(diff * diff / dist.cov, dim=-1)
            logdet = torch.sum(torch.log(dist.cov))
        d = dist.mean.shape[-1]
        return -0.5 * (quad + logdet + d * math.log(2.0 * math.pi))
    if isinstance(dist, ParticleGMM):
        flat = x.reshape(-1, x.shape[-1])
        lp = gmm_log_prob(flat, dist.means, dist.var, dist.weights)
        return lp.reshape(x.shape[:-1])
    raise TypeError(f"Unknown distribution type: {type(dist)}")


def in_bounds(x: torch.Tensor, low, high) -> torch.Tensor:
    """Whether each sample (last axis) lies within ``[low, high]``."""
    return torch.all((x >= low) & (x <= high), dim=-1, keepdim=True)


def sample_rejection(dist: Distribution, shape: Tuple[int, ...],
                     low: float = -math.inf, high: float = math.inf,
                     max_rounds: int = 50,
                     generator: Optional[torch.Generator] = None, *,
                     eps: Optional[torch.Tensor] = None,
                     comps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Samples within ``[low, high]``: out-of-bounds draws are redrawn for
    ``max_rounds`` fixed-shape rounds, then clipped. Given draws carry a
    leading axis of ``max_rounds + 1``: the first draw, then each round's."""
    def draw(r):
        return sample(dist, shape, generator,
                      eps=None if eps is None else eps[r],
                      comps=None if comps is None else comps[r])

    x = draw(0)
    for r in range(1, max_rounds + 1):
        x = torch.where(in_bounds(x, low, high), x, draw(r))
    return clip(x, low, high)


def moments(dist: Distribution) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, covariance)``."""
    if isinstance(dist, Gaussian):
        cov = dist.cov if dist.cov.ndim == 2 else torch.diag(dist.cov)
        return dist.mean, cov
    if isinstance(dist, ParticleGMM):
        w = dist.weights / torch.sum(dist.weights)
        mean = torch.sum(w[:, None] * dist.means, dim=0)
        diff = dist.means - mean
        cov = torch.einsum("k,ki,kj->ij", w, diff, diff)
        var = torch.as_tensor(dist.var, dtype=cov.dtype, device=cov.device)
        return mean, cov + torch.diag(var.expand(dist.means.shape[-1]))
    raise TypeError(f"Unknown distribution type: {type(dist)}")
