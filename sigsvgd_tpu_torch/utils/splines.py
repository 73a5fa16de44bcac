"""Natural cubic splines (port of ``sigsvgd_tpu/utils/splines.py``).

Coefficients come from the tridiagonal system for the knot second
derivatives, solved by the Thomas algorithm (a Python loop over the knots,
differentiable by autograd); evaluation is a gather and a cubic. The
gather is a product with the queries' one-hot segment matrix: exact
forward, and a backward without atomic adds, so the gradient on the card
is the same run to run (``index_select``'s backward, an ``index_add_``,
sums in the order its atomics land). Leading batch dimensions of the knot
values are carried through every function.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CubicSpline(NamedTuple):
    """``S(t) = y_i + b_i dt + c_i dt² + d_i dt³`` on ``[t_i, t_{i+1}]``.

    Shapes: ``t [n]``, ``y [..., n, ch]``, ``b/c/d [..., n-1, ch]``.
    """

    t: torch.Tensor
    y: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor


def _thomas_solve(lower, diag, upper, rhs):
    """Tridiagonal solve by the Thomas algorithm: ``lower``/``upper [m-1]``,
    ``diag [m]``, ``rhs [..., m, ch]`` → ``[..., m, ch]``, in the JAX
    scan's order of operations."""
    m = diag.shape[0]
    zero = torch.zeros((1,), dtype=diag.dtype, device=diag.device)
    up = torch.cat([upper, zero])
    lo = torch.cat([zero, lower])
    cp_prev = torch.zeros((), dtype=diag.dtype, device=diag.device)
    dp_prev = torch.zeros_like(rhs[..., 0, :])
    cps, dps = [], []
    for i in range(m):
        denom = diag[i] - lo[i] * cp_prev
        cp_prev = up[i] / denom
        dp_prev = (rhs[..., i, :] - lo[i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(dp_prev)
    xs = [None] * m
    for i in range(m - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-2)


def natural_cubic_spline_coeffs(t: torch.Tensor, y: torch.Tensor) -> CubicSpline:
    """Natural cubic spline (zero second derivative at both ends) through
    ``(t_i, y_i)``: ``t [n]`` strictly increasing, ``y [..., n, ch]``."""
    n, ch = y.shape[-2:]
    h = t[1:] - t[:-1]  # [n-1]
    if n == 2:
        b = (y[..., 1:, :] - y[..., :-1, :]) / h[:, None]
        z = torch.zeros_like(b)
        return CubicSpline(t, y, b, z, z)
    slope = (y[..., 1:, :] - y[..., :-1, :]) / h[:, None]  # [..., n-1, ch]
    rhs = slope[..., 1:, :] - slope[..., :-1, :]  # [..., n-2, ch]
    diag = (h[:-1] + h[1:]) / 3.0
    off = h[1:-1] / 6.0
    m_inner = _thomas_solve(off, diag, off, rhs)
    edge = torch.zeros_like(m_inner[..., :1, :])
    m = torch.cat([edge, m_inner, edge], dim=-2)
    b = slope - h[:, None] * (2.0 * m[..., :-1, :] + m[..., 1:, :]) / 6.0
    c = m[..., :-1, :] / 2.0
    d = (m[..., 1:, :] - m[..., :-1, :]) / (6.0 * h[:, None])
    return CubicSpline(t, y, b, c, d)


def _locate(t: torch.Tensor, tq: torch.Tensor):
    """Each query's segment as a one-hot ``[m, n-1]`` matrix, and its
    offset into the segment."""
    idx = torch.searchsorted(t, tq, right=True) - 1
    idx = torch.clamp(idx, 0, t.shape[0] - 2)
    segments = torch.arange(t.shape[0] - 1, device=t.device)
    onehot = (idx[:, None] == segments).to(tq.dtype)
    return onehot, tq - t[idx]


def spline_evaluate(spline: CubicSpline, tq: torch.Tensor) -> torch.Tensor:
    """Values at query times ``tq [m]`` → ``[..., m, ch]``."""
    onehot, dt = _locate(spline.t, tq)
    dt = dt[:, None]
    y = onehot @ spline.y[..., :-1, :]
    b = onehot @ spline.b
    c = onehot @ spline.c
    d = onehot @ spline.d
    return y + dt * (b + dt * (c + dt * d))


def spline_derivative(spline: CubicSpline, tq: torch.Tensor,
                      order: int = 1) -> torch.Tensor:
    """First or second derivative at ``tq [m]`` → ``[..., m, ch]``."""
    onehot, dt = _locate(spline.t, tq)
    dt = dt[:, None]
    b = onehot @ spline.b
    c = onehot @ spline.c
    d = onehot @ spline.d
    if order == 1:
        return b + dt * (2.0 * c + 3.0 * dt * d)
    if order == 2:
        return 2.0 * c + 6.0 * dt * d
    raise ValueError("order must be 1 or 2")


def spline_trajectory(knots: torch.Tensor, timesteps: int) -> torch.Tensor:
    """Knots ``[..., n, ch]`` at times ``linspace(0, 1, n)`` → the spline
    sampled at ``linspace(0, 1, timesteps)``: ``[..., T, ch]``."""
    n = knots.shape[-2]
    t = torch.linspace(0.0, 1.0, n, dtype=knots.dtype, device=knots.device)
    spline = natural_cubic_spline_coeffs(t, knots)
    tq = torch.linspace(0.0, 1.0, timesteps, dtype=knots.dtype, device=knots.device)
    return spline_evaluate(spline, tq)
