"""Core math utilities (port of ``sigsvgd_tpu/utils/math.py``).

Elementwise helpers ``clip``, ``relu`` and ``jabs`` keep JAX's gradients at
ties, which differ from PyTorch's own: ``jnp.clip`` and ``jnp.maximum(x, 0)``
split a tie 0.5/0.5 (``torch.clamp`` and ``clamp_min`` give 1), and
``jnp.abs`` has gradient 1 at 0 (``torch.abs`` gives 0).
"""
from __future__ import annotations

import math

import torch


def _full_like(x: torch.Tensor, v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=x.device, dtype=x.dtype).expand_as(x)
    return torch.full_like(x, float(v))


def clip(x: torch.Tensor, low, high) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, low), high)`` with tie gradient 0.5."""
    return torch.minimum(torch.maximum(x, _full_like(x, low)), _full_like(x, high))


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)`` with tie gradient 0.5."""
    return torch.maximum(x, torch.zeros_like(x))


def jabs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with gradient 1 at 0."""
    return torch.where(x >= 0, x, -x)


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at zero."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def pw_dist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[n, d] × [m, d] → [n, m]`` squared distances, clamped at 0."""
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    yn = torch.sum(y * y, dim=-1, keepdim=True)
    d2 = xn + yn.T - 2.0 * (x @ y.T)
    return relu(d2)


def scaled_pw_dist_sq(x: torch.Tensor, y: torch.Tensor, metric: torch.Tensor,
                      return_gradient: bool = False):
    """``[n, d] × [m, d] → [n, m]`` metric-scaled squared distances
    ``(x_i - y_j) M (x_i - y_j)ᵀ``, clamped at 0; with ``return_gradient``
    also ``diff @ M`` (``[n, m, d]``, half the gradient in ``x_i`` for a
    symmetric ``M``)."""
    diff = x[:, None, :] - y[None, :, :]
    diff_m = diff @ metric
    d2 = relu(torch.sum(diff_m * diff, dim=-1))
    if return_gradient:
        return d2, diff_m
    return d2


def bw_median(sq_dists: torch.Tensor, bw_scale: float = 1.0,
              tol: float = 1e-8) -> torch.Tensor:
    """Median-heuristic bandwidth ``bw_scale·sqrt(median/log(n+1))``; the
    median is the lower middle order statistic (``torch.median``'s rule).
    Under autograd its gradient goes where the JAX package's
    ``jnp.partition`` sends it: to the element a stable ascending sort puts
    at the median's position (the second of two tied twins when both sit
    at or below it), not where ``torch.median``'s backward would."""
    flat = sq_dists.reshape(-1)
    if torch.is_grad_enabled() and flat.requires_grad:
        k = (flat.shape[0] - 1) // 2
        med = flat[torch.sort(flat.detach(), stable=True).indices[k]]
    else:
        med = torch.median(flat)
    return bw_from_median(med, sq_dists.shape[0], bw_scale, tol)


def bw_from_median(med: torch.Tensor, n: int, bw_scale: float = 1.0,
                   tol: float = 1e-8) -> torch.Tensor:
    """``bw_scale·sqrt(med/log(n+1))`` clamped to ``tol``, for a median
    computed elsewhere."""
    h2 = med / math.log(n + 1.0)
    return torch.clamp_min(bw_scale * torch.sqrt(h2), tol)


def bw_median_diff(sq_dists: torch.Tensor, bw_scale: float = 1.0,
                   tol: float = 1e-8) -> torch.Tensor:
    """:func:`bw_median`'s value with its gradient routed to the first
    element, in row-major order, that equals the median. A symmetric
    distance matrix holds its median twice, and ``torch.median``'s own
    backward picks a twin by its own rule: the index is found on the
    detached values and the differentiable values are read there."""
    flat = sq_dists.reshape(-1)
    fs = flat.detach()
    idx = torch.argmax((fs == torch.median(fs)).to(torch.uint8))
    return bw_from_median(flat[idx], sq_dists.shape[0], bw_scale, tol)


def bw_silverman(x: torch.Tensor, bw_scale: float = 1.0) -> torch.Tensor:
    """Silverman's rule over axis 0: ``0.9·A·n^(-1/5)`` with ``A`` the
    per-column unbiased std, or the IQR/1.349 of the flattened array (one
    scalar, linear interpolation) where that is positive and below the
    smallest per-column std."""
    n = x.shape[0]
    flat = x.reshape(-1)
    iqr = (torch.quantile(flat, 0.75) - torch.quantile(flat, 0.25)) / 1.349
    std = torch.std(x, dim=0, correction=1)
    use_iqr = (iqr > 0) & (iqr < torch.min(std))
    a = torch.where(use_iqr, iqr.expand_as(std), std)
    return bw_scale * 0.9 * a * n ** (-0.2)


def grad_gmm_log_p(samples: torch.Tensor, means: torch.Tensor,
                   var, weights: torch.Tensor) -> torch.Tensor:
    """Unweighted-responsibility GMM prior gradient ``-(x - w@μ)/σ²``."""
    ss = samples.shape
    s = samples.reshape(ss[0], -1)
    m = means.reshape(means.shape[0], -1)
    v = torch.as_tensor(var, dtype=s.dtype, device=s.device).expand(m.shape[-1])
    w = weights / torch.sum(weights)
    grad = -(s - w[None, :] @ m) / v
    return grad.reshape(ss)


def smoothed_box_log_prob(x: torch.Tensor, low, high,
                          sigma: float = 0.1) -> torch.Tensor:
    """Gaussian-smoothed uniform-box log-density over the last axis."""
    low = torch.as_tensor(low, dtype=x.dtype, device=x.device)
    high = torch.as_tensor(high, dtype=x.dtype, device=x.device)
    center = 0.5 * (low + high)
    half_width = 0.5 * (high - low)
    out_dist = relu(jabs(x - center) - half_width)
    log_z = torch.log(2.0 * half_width + math.sqrt(2.0 * math.pi) * sigma)
    return torch.sum(-0.5 * (out_dist / sigma) ** 2 - log_z, dim=-1)


def gmm_log_prob(samples: torch.Tensor, means: torch.Tensor, var,
                 weights: torch.Tensor) -> torch.Tensor:
    """``[s]`` log-densities of an equal-bandwidth GMM on particle ``means``
    (``[k, *event]``; ``var`` scalar or ``[*event]``, ``weights [k]``
    unnormalized) at ``samples [s, *event]``."""
    s = samples.reshape(samples.shape[0], -1)
    m = means.reshape(means.shape[0], -1)
    v = torch.as_tensor(var, dtype=s.dtype, device=s.device).expand(m.shape[-1])
    logw = torch.log_softmax(torch.log(weights), dim=0)
    diff = s[:, None, :] - m[None, :, :]
    quad = -0.5 * torch.sum(diff * diff / v, dim=-1)
    log_norm = -0.5 * torch.sum(torch.log(2.0 * math.pi * v))
    return torch.logsumexp(logw[None, :] + quad + log_norm, dim=-1)


def exact_grad_gmm_log_p(samples: torch.Tensor, means: torch.Tensor, var,
                         weights: torch.Tensor) -> torch.Tensor:
    """Exact ``∇_x log p_GMM(x)``, by autograd of :func:`gmm_log_prob`."""
    with torch.enable_grad():
        x = samples.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(gmm_log_prob(x, means, var, weights).sum(), x)
    return g


def cholesky_psd(m: torch.Tensor, jitter: float = 1e-8,
                 lower: bool = True) -> torch.Tensor:
    """Cholesky factor of ``m + jitter·I`` (its transpose if not ``lower``)."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    chol = torch.linalg.cholesky(m + jitter * eye)
    return chol if lower else chol.mT
