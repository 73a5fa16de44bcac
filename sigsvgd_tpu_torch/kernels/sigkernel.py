"""Untruncated signature kernel via the Goursat PDE (port of the subset of
``sigsvgd_tpu/kernels/sigkernel.py`` the MPC solve needs).

Discretisation, as the JAX package: with ``z = inc / 4^λ``,

    k[i+1,j+1] = (k[i+1,j] + k[i,j+1])·(1 + z/2 + z²/12) − k[i,j]·(1 − z²/12)

where ``inc`` is the double difference of the static Gram on the coarse grid.

``gram_and_grad`` routes by dyadic order and device, as the JAX package's
block routes do: λ=0 goes to ``sigkernel_block.block_gram_and_grad`` (K1)
and λ=3 to ``sigkernel_block3.block3_gram_and_grad`` (K2), each the plain
twin on the CPU and the kernel on the card. Other orders raise: the JAX
package takes them through its XLA wavefront and MXU routes, which are
ROADMAP.md queue 1, M6 and M10.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.math import bw_median, relu
from .sigkernel_block import block_gram_and_grad
from .sigkernel_block3 import block3_gram_and_grad


def _pair_sq_dists(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``[n, L, C] × [m, L', C] → [n, m, L, L']`` squared distances."""
    xn = torch.sum(X * X, dim=-1)
    yn = torch.sum(Y * Y, dim=-1)
    cross = torch.einsum("npc,mqc->nmpq", X, Y)
    d2 = xn[:, None, :, None] + yn[None, :, None, :] - 2.0 * cross
    return relu(d2)


def static_gram_rbf(X: torch.Tensor, Y: torch.Tensor, h) -> torch.Tensor:
    """``κ(x, y) = exp(-||x-y||² / h)`` (``h`` not squared)."""
    return torch.exp(-_pair_sq_dists(X, Y) / h)


def gram_increments(gram: torch.Tensor) -> torch.Tensor:
    """Double forward difference ``[..., L, L'] → [..., L-1, L'-1]``."""
    return (
        gram[..., 1:, 1:] - gram[..., 1:, :-1] - gram[..., :-1, 1:]
        + gram[..., :-1, :-1]
    )


def solve_goursat_pde(inc: torch.Tensor, dyadic_order: int = 0) -> torch.Tensor:
    """Plain forward solve ``[B, Lx-1, Ly-1] → [B]`` for any dyadic order:
    a row sweep over the refined grid, differentiable by autograd."""
    b, lx1, ly1 = inc.shape
    z = inc / float(4 ** dyadic_order)
    a_c = 1.0 + 0.5 * z + z * z * (1.0 / 12.0)
    b_c = 1.0 - z * z * (1.0 / 12.0)
    gx, gy = lx1 << dyadic_order, ly1 << dyadic_order
    ones = torch.ones(b, dtype=inc.dtype, device=inc.device)
    row = [ones] * (gy + 1)
    for i in range(gx):
        ci = i >> dyadic_order
        new = [ones]
        for j in range(gy):
            cj = j >> dyadic_order
            new.append((new[j] + row[j + 1]) * a_c[:, ci, cj]
                       - row[j] * b_c[:, ci, cj])
        row = new
    return row[gy]


@dataclasses.dataclass(frozen=True)
class SignatureKernel:
    """Untruncated signature kernel with an RBF static kernel.

    Attributes:
      dyadic_order: grid refinement exponent λ.
      bandwidth: fixed static-kernel bandwidth ``h`` (κ = exp(-d²/h)); if
        None, the median heuristic.
    """

    dyadic_order: int = 3
    bandwidth: Optional[float] = None

    def _bandwidth_from(self, d2_flat: torch.Tensor):
        if self.bandwidth is not None:
            return float(self.bandwidth)
        return bw_median(d2_flat)

    def _static_gram(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        d2 = _pair_sq_dists(X, Y)
        return torch.exp(-d2 / self._bandwidth_from(d2.reshape(X.shape[0], -1)))

    def _subsampled_bandwidth(self, X: torch.Tensor, Y: torch.Tensor):
        """Bandwidth from the first ``256×256`` path block (the JAX
        package's documented estimate at scale)."""
        ns, ms = min(X.shape[0], 256), min(Y.shape[0], 256)
        d2s = _pair_sq_dists(X[:ns], Y[:ms])
        return self._bandwidth_from(d2s.reshape(ns, -1))

    def gram(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Full Gram ``K [n, m]`` by the plain solver (any order)."""
        n, m = X.shape[0], Y.shape[0]
        inc = gram_increments(self._static_gram(X, Y))
        inc = inc.reshape(n * m, X.shape[1] - 1, Y.shape[1] - 1)
        return solve_goursat_pde(inc, self.dyadic_order).reshape(n, m)

    def gram_and_grad(self, X: torch.Tensor):
        """``(K, ∂ΣK/∂X)`` with the second argument detached, at λ=0 (K1)
        or λ=3 (K2); the plain twins on the CPU."""
        routes = {0: block_gram_and_grad, 3: block3_gram_and_grad}
        if self.dyadic_order not in routes:
            raise NotImplementedError(
                f"gram_and_grad at dyadic_order={self.dyadic_order} takes the "
                "JAX package's XLA wavefront or MXU route, not ported yet "
                "(ROADMAP.md queue 1, M6 and M10)"
            )
        return routes[self.dyadic_order](X, self._subsampled_bandwidth(X, X))

    def calibrate_dyadic_order(self, X: torch.Tensor, tol: float = 1e-3,
                               n_sample: int = 32) -> "SignatureKernel":
        """Order 0 if the z³ truncation bound on these paths is within
        ``tol``, else this kernel unchanged (the choice is {0, own order})."""
        if self.dyadic_order == 0:
            return self
        if float(self.calibration_bound(X, n_sample)) <= tol:
            return dataclasses.replace(self, dyadic_order=0)
        return self

    def calibration_bound(self, X: torch.Tensor, n_sample: int = 32) -> torch.Tensor:
        """``4·max_pairs Σ_cells |z|³`` over the first ``n_sample`` paths."""
        Xs = X[: min(n_sample, X.shape[0])]
        z = gram_increments(self._static_gram(Xs, Xs))
        return 4.0 * torch.amax(torch.sum(torch.abs(z) ** 3, dim=(-2, -1)))
