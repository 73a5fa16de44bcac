"""Static kernels with analytic gradients (port of
``sigsvgd_tpu/kernels/rbf.py``): Gaussian and IMQ, plain and metric-scaled.

``__call__(X, Y)`` returns the Gram ``K [n, m]`` or ``(K, dK)`` with
``dK[i] = Σ_j ∂k(X_i, Y_j)/∂X_i`` (``[n, d]``, the form the SVGD update
consumes), each gradient in matmul form with no ``[n, m, d]``
intermediate. The scaled kernels take a metric ``M``, symmetrised as
``½(M + Mᵀ)`` (the identity when None); the plain ones ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..utils.math import bw_median, pw_dist_sq, scaled_pw_dist_sq

BandwidthFn = Callable[[torch.Tensor], torch.Tensor]


def _as2d(x: torch.Tensor) -> torch.Tensor:
    x = torch.atleast_2d(x)
    return x.reshape(x.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class BaseKernel:
    """Bandwidth plumbing: ``bandwidth_fn`` maps the pairwise squared
    distances to a scalar ``h``; the default is the median heuristic.
    ``analytic_grad`` is accepted and not read, as in the JAX package: the
    kernels return their analytic gradient either way."""

    bandwidth_fn: Optional[BandwidthFn] = None
    bw_scale: float = 1.0
    analytic_grad: bool = True

    def bandwidth(self, sq_dists: torch.Tensor, h=None) -> torch.Tensor:
        if h is not None:
            return torch.as_tensor(h, dtype=sq_dists.dtype, device=sq_dists.device)
        if self.bandwidth_fn is not None:
            return torch.as_tensor(self.bandwidth_fn(sq_dists), dtype=sq_dists.dtype,
                                   device=sq_dists.device)
        return bw_median(sq_dists, self.bw_scale)


@dataclasses.dataclass(frozen=True)
class GaussianKernel(BaseKernel):
    """``k(x, y) = exp(-½ ||x - y||² / h²)``, ``∂k/∂x = -(x - y)/h² · k``."""

    def __call__(self, X, Y, h=None, compute_grad: bool = True, **_):
        X, Y = _as2d(X), _as2d(Y)
        d2 = pw_dist_sq(X, Y)
        h = self.bandwidth(d2, h)
        K = torch.exp(-0.5 * d2 / h**2)
        if not compute_grad:
            return K
        # Σ_j -(x_i - y_j) K_ij = K @ Y - rowsum(K) ⊙ x_i: two matmuls, no
        # [n, m, d] intermediate
        dK = (K @ Y - torch.sum(K, dim=1, keepdim=True) * X) / h**2
        return K, dK


def _metric(M, X: torch.Tensor) -> torch.Tensor:
    if M is None:
        return torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return 0.5 * (M + M.T)


@dataclasses.dataclass(frozen=True)
class ScaledGaussianKernel(BaseKernel):
    """``k(x, y) = exp(-½ (x-y) M (x-y)ᵀ / h²)``, the matrix-SVGD kernel;
    not premultiplied by ``M⁻¹`` (the sampler preconditions)."""

    def __call__(self, X, Y, M=None, h=None, compute_grad: bool = True, **_):
        X, Y = _as2d(X), _as2d(Y)
        M = _metric(M, X)
        d2 = scaled_pw_dist_sq(X, Y, M)
        h = self.bandwidth(d2, h)
        K = torch.exp(-0.5 * d2 / h**2)
        if not compute_grad:
            return K
        # Σ_j -(x_i - y_j)M K_ij = (K @ Y - rowsum(K) ⊙ x_i) @ M
        dK = ((K @ Y - torch.sum(K, dim=1, keepdim=True) * X) @ M) / h**2
        return K, dK


@dataclasses.dataclass(frozen=True)
class IMQKernel(BaseKernel):
    """Inverse multiquadric ``k(x, y) = (1 + ½ ||x-y||²/h²)^(-1/2)`` with the
    true derivative in ``x``, ``-½ (1 + ½ d²/h²)^(-3/2) (x-y)/h²``, as the
    JAX package (the upstream code's ``(y - x)`` is a sign slip there)."""

    def __call__(self, X, Y, h=None, compute_grad: bool = True, **_):
        X, Y = _as2d(X), _as2d(Y)
        d2 = pw_dist_sq(X, Y)
        h = self.bandwidth(d2, h)
        denom = 1.0 + 0.5 * d2 / h**2
        K = denom ** -0.5
        if not compute_grad:
            return K
        W = -0.5 * denom ** -1.5 / h**2
        dK = torch.sum(W, dim=1, keepdim=True) * X - W @ Y
        return K, dK


@dataclasses.dataclass(frozen=True)
class ScaledIMQKernel(BaseKernel):
    """Metric-scaled IMQ ``k(x, y) = (1 + ½ (x-y)M(x-y)ᵀ/h²)^(-1/2)``."""

    def __call__(self, X, Y, M=None, h=None, compute_grad: bool = True, **_):
        X, Y = _as2d(X), _as2d(Y)
        M = _metric(M, X)
        d2 = scaled_pw_dist_sq(X, Y, M)
        h = self.bandwidth(d2, h)
        denom = 1.0 + 0.5 * d2 / h**2
        K = denom ** -0.5
        if not compute_grad:
            return K
        W = -0.5 * denom ** -1.5 / h**2
        dK = (torch.sum(W, dim=1, keepdim=True) * X - W @ Y) @ M
        return K, dK
