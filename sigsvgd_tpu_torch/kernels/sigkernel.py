"""Untruncated signature kernel via the Goursat PDE (port of the subset of
``sigsvgd_tpu/kernels/sigkernel.py`` the MPC solves and the planner need).

Discretisation, as the JAX package: with ``z = inc / 4^λ``,

    k[i+1,j+1] = (k[i+1,j] + k[i,j+1])·(1 + z/2 + z²/12) − k[i,j]·(1 − z²/12)

where ``inc`` is the double difference of the static Gram (RBF, or linear
with ``static="linear"``) on the coarse grid.

Routing (``SignatureKernel._solver_kind``), as the JAX package routes on the
TPU (``solver="auto"``; the explicit solvers as the JAX package maps them):
λ=0 with ly1 ≤ 63 and RBF statics → the ``"small"`` kind:
``gram_and_grad`` takes ``sigkernel_block.block_gram_and_grad`` (K1) inside
both K1's block envelope and the JAX package's, else the gathered
upper-triangle pair list through ``sigkernel_small`` (K7's forward and
backward), and ``gram`` above ``_DENSE_LIMIT`` streams pair chunks through
K7; ``gram_sym`` takes ``sigkernel_block.block_gram`` (K3) inside K3's
envelope and the JAX package's block envelope (C ≤ 8, L·C ≤ 128), where the
JAX package takes its block values kernel, else the upper-triangle pair
list. λ=3 with ly1 ≤ 48 → the
``"pallas"`` kind: ``gram_and_grad`` takes
``sigkernel_block3.block3_gram_and_grad`` (K2) at ``grad_precision="fp32"``
inside K2's envelope (RBF statics), else the gathered upper-triangle pair
list; a pair list takes ``sigkernel_fused`` inside the fused envelope (RBF
statics, C ≤ 8: K4's forward, then K4's fp32 backward or, at
``grad_precision="bf16"`` inside JAX's bf16 envelope, K6), else
``sigkernel_tiled.pair_values`` (linear statics or C > 8: the increments in
torch, K5's forward and backward); ``gram`` above ``_DENSE_LIMIT`` streams
pair chunks through those pair lists, and the dense λ=3 ``gram`` solves its
increments by K5 (``solve_goursat_pde_tiled``). Shapes the block propagator
takes (λ ≥ 4, at most 256 block hops) → the hop chain K8
(``mxu_chain.solve_goursat_pde_mxu_chain``) when ``mxu_precision="default"``
and K8 takes the shape, else the fp32 block propagator
:func:`solve_goursat_pde_mxu`. Each kernel runs its plain twin on the CPU.
The JAX package's XLA wavefront (λ = 1, 2; λ=0 with linear statics or
beyond the pair lists' envelopes; ``solver="wavefront"``) raises naming
ROADMAP M6, except that the dense ``gram`` runs the plain solve there.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.math import bw_median, relu
from .mxu_chain import chain_supported, solve_goursat_pde_mxu_chain
from . import sigkernel_fused, sigkernel_small, sigkernel_tiled
from .sigkernel_block import (
    block_gram, block_gram_and_grad, block_supported, block_values_supported,
    jax_block_supported,
)
from .sigkernel_block3 import block3_gram_and_grad, block3_supported
from .sigkernel_fused import fused_supported, pair_gram_fused, pallas_supported
from .sigkernel_small import pair_gram_small, small_supported
from .sigkernel_tiled import pair_values, solve_goursat_pde_tiled

_MXU_PRECISIONS = ("highest", "high", "default")
_GRAD_PRECISIONS = ("fp32", "bf16")
_STATICS = ("rbf", "linear")
_SOLVERS = ("auto", "wavefront", "mxu", "mxu_pallas", "pallas", "pallas_small")


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


def static_gram_linear(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``κ(x, y) = ⟨x, y⟩``: ``[n, L, C] × [m, L', C] → [n, m, L, L']``."""
    return torch.einsum("npc,mqc->nmpq", X, Y)


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


# ---------------------------------------------------------------------------
# Block-propagator solver (high dyadic orders). Within one m×m block of fine
# cells sharing one z the recurrence is linear with constant coefficients:
# its south row + west column (2m+1 nodes) map to its north row + east
# column by M(z) = Σ_d z^d M_d, with data-independent basis matrices M_d.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _propagator_polys(m: int, degree: int) -> np.ndarray:
    """Basis matrices ``M_d [degree+1, 2m+1, 2m+1]`` (float32 numpy, cached)
    with ``out = Σ_d z^d M_d @ in`` for one m×m constant-z block:

    in  = [south row nodes i=0..m] ++ [west col nodes j=1..m]
    out = [north row nodes i=0..m] ++ [east col nodes j=1..m]

    The port's own copy of the JAX package's function (float64 polynomial
    algebra, rounded once to float32)."""
    D = degree
    nb = 2 * m + 1
    a = np.zeros(D + 1)
    a[0] = 1.0
    if D >= 1:
        a[1] = 0.5
    if D >= 2:
        a[2] = 1.0 / 12.0
    bp = np.zeros(D + 1)
    bp[0] = 1.0
    if D >= 2:
        bp[2] = -1.0 / 12.0

    def pmul(p, q):
        out = np.zeros_like(p)
        for d in range(D + 1):
            if q[d] != 0.0:
                out[:, d:] += p[:, : D + 1 - d] * q[d]
        return out

    # node polynomials [nb(basis), D+1]; south row = basis e_0..e_m
    prev = [np.zeros((nb, D + 1)) for _ in range(m + 1)]
    for i in range(m + 1):
        prev[i][i, 0] = 1.0
    east = []
    for j in range(1, m + 1):
        row = [np.zeros((nb, D + 1))]
        row[0][m + j, 0] = 1.0  # west input node (0, j)
        for i in range(1, m + 1):
            row.append(pmul(prev[i] + row[i - 1], a) - pmul(prev[i - 1], bp))
        east.append(row[m])
        prev = row
    outs = prev + east  # north row (i=0..m at j=m) ++ east col (j=1..m)
    M = np.stack([np.stack([o[:, d] for o in outs]) for d in range(D + 1)])
    return np.ascontiguousarray(M, dtype=np.float32)


def solve_goursat_pde_mxu(inc: torch.Tensor, dyadic_order: int,
                          degree: int = 10) -> torch.Tensor:
    """Block-propagator PDE solve ``inc [B, lx1, ly1]`` → ``[B]`` in full
    fp32 (the JAX package's XLA ``"mxu"`` route at ``precision="highest"``):
    each hop is one fp32 matmul against all degree slices (TF32 stays off,
    ``sigsvgd_tpu_torch/__init__.py``), the last input node folds in as a
    rank-1 term, then the degree contraction with powers of z by repeated
    multiplication. Blocks are ``m = min(64, 2^λ)`` fine cells wide.
    Differentiable by autograd; each hop is checkpointed, so the backward
    recomputes its ``[B, D+1, 2m+1]`` temporary."""
    b, lx1, ly1 = inc.shape
    lam = dyadic_order
    m = min(64, 1 << lam)
    sub = (1 << lam) // m
    nbx, nby = lx1 * sub, ly1 * sub
    Md = torch.from_numpy(_propagator_polys(m, degree)).to(inc.device)
    D1, nb = Md.shape[0], Md.shape[1]
    Md_main = Md[:, :, :-1].reshape(D1 * nb, nb - 1)  # [(D+1)·nb, nb-1]
    Md_last = Md[:, :, -1]                             # [D+1, nb]
    z = inc / float(4 ** lam)

    def prop(inp, zcell):
        pows = [torch.ones_like(zcell)]
        for _ in range(degree):
            pows.append(pows[-1] * zcell)
        zp = torch.stack(pows, dim=1)  # [B, D+1]
        tmp = (inp[:, :-1] @ Md_main.T).reshape(-1, D1, nb)
        tmp = tmp + inp[:, -1][:, None, None] * Md_last[None]
        return torch.einsum("bkf,bk->bf", tmp, zp)

    rows = [torch.ones(b, m + 1, dtype=inc.dtype, device=inc.device)] * nbx
    for J in range(nby):
        west = torch.ones(b, m, dtype=inc.dtype, device=inc.device)
        for I in range(nbx):
            inp = torch.cat([rows[I], west], dim=-1)
            zc = z[:, I // sub, J // sub]
            if torch.is_grad_enabled() and (inp.requires_grad or zc.requires_grad):
                out = checkpoint(prop, inp, zc, use_reentrant=False)
            else:
                out = prop(inp, zc)
            rows[I] = out[:, : m + 1]
            west = out[:, m + 1:]
    return rows[-1][:, m]


def _mxu_eligible(lx1: int, ly1: int, dyadic_order: int) -> bool:
    if dyadic_order < 4:
        return False
    m = min(64, 1 << dyadic_order)
    sub = (1 << dyadic_order) // m
    return (lx1 * sub) * (ly1 * sub) <= 256  # unrolled block count cap


@dataclasses.dataclass(frozen=True)
class SignatureKernel:
    """Untruncated signature kernel with an RBF (or linear) static kernel.

    Attributes:
      dyadic_order: grid refinement exponent λ.
      bandwidth: fixed static-kernel bandwidth ``h`` (κ = exp(-d²/h)); if
        None, the median heuristic, scaled by ``bw_scale``.
      static: "rbf" or "linear" (κ = ⟨x, y⟩; no bandwidth).
      solver: the JAX package's solver choice: "auto" routes as the JAX
        package does on the TPU; "pallas" pins the λ=3 kernels, and
        "pallas_small" the λ=0 ones; "mxu" the fp32 block propagator;
        "mxu_pallas" the hop chain K8 where it takes the shape, else the
        fp32 block propagator. "wavefront" raises: the XLA wavefront is
        not ported (ROADMAP M6).
      mxu_degree: degree of the block propagator's series in z.
      mxu_precision: "default" sends block-propagator shapes K8 takes to the
        hop chain (bf16 products, fp32 accumulation), as the JAX package
        does on the TPU; "highest" and "high" take the fp32 block
        propagator. The port has no 3-pass bf16 product, so "high" runs as
        "highest" (full fp32).
      grad_precision: adjoint of the λ=3 fused pair-list route: "fp32"
        (K4's exact adjoint) or "bf16" (K6's first-order delta form,
        gradient-grade only; values are unchanged). As in the JAX package,
        "bf16" skips the block route and falls back to the fp32 adjoint
        outside its envelope (ly1 ≤ 40, C ≤ 4).
    """

    dyadic_order: int = 3
    bandwidth: Optional[float] = None
    bw_scale: float = 1.0
    static: str = "rbf"
    solver: str = "auto"
    mxu_degree: int = 10
    mxu_precision: str = "highest"
    grad_precision: str = "fp32"

    # above this many floats for the [n, m, L, L'] static-Gram tensor the
    # Gram streams by pair chunks
    _DENSE_LIMIT = 2 * 10**8

    def __post_init__(self):
        for name, allowed in (("static", _STATICS), ("solver", _SOLVERS),
                              ("mxu_precision", _MXU_PRECISIONS),
                              ("grad_precision", _GRAD_PRECISIONS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")

    def _solver_kind(self, lx1: int, ly1: int, dense: bool = False) -> str:
        """``"small"`` (λ=0, ly1 ≤ 63, RBF statics: K1 or K3 on a block, else
        the K7 pair list), ``"pallas"`` (λ=3, ly1 ≤ 48: K2, the K4/K6 pair
        list or K5), ``"mxu_chain"`` (K8) or ``"mxu"`` (the fp32 block
        propagator), as the JAX package maps ``solver``. Shapes that only
        its XLA wavefront takes raise, except on the dense ``gram``
        (``dense``), where the plain solve (``"plain"``) takes them unless
        ``solver="wavefront"`` was asked for."""
        lam, solver = self.dyadic_order, self.solver
        if solver == "mxu_pallas":
            return "mxu_chain" if chain_supported(lx1, ly1, lam) else "mxu"
        if solver == "mxu":
            return "mxu"
        if (solver in ("auto", "pallas_small") and lam == 0 and ly1 <= 63
                and self.static == "rbf"):
            return "small"
        if solver == "auto" and _mxu_eligible(lx1, ly1, lam):
            if self.mxu_precision == "default" and chain_supported(lx1, ly1, lam):
                return "mxu_chain"
            return "mxu"
        if solver in ("auto", "pallas") and pallas_supported(lx1, ly1, lam):
            return "pallas"
        if dense and solver != "wavefront":
            return "plain"
        raise NotImplementedError(
            f"dyadic_order={lam} ({self.static} statics, solver={solver!r}) at "
            f"{lx1 + 1}x{ly1 + 1}-node paths takes the JAX package's XLA wavefront "
            "route with its memory-bounded adjoint, not ported yet (ROADMAP.md "
            "queue 1, M6)"
        )

    def _bandwidth_from(self, d2_flat: torch.Tensor):
        if self.bandwidth is not None:
            return float(self.bandwidth)
        return bw_median(d2_flat, self.bw_scale)

    def _static_gram(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        if self.static == "linear":
            return static_gram_linear(X, Y)
        d2 = _pair_sq_dists(X, Y)
        return torch.exp(-d2 / self._bandwidth_from(d2.reshape(X.shape[0], -1)))

    def _fused(self, lx1: int, ly1: int, n_channels: int, h, grad_precision="fp32") -> bool:
        return fused_supported(lx1, ly1, self.dyadic_order, n_channels, self.static, h,
                               grad_precision)

    def _chunk_plan(self, lx1: int, ly1: int, total: int, n_channels: int, device, h):
        """(solver kind, pair-chunk size, chunk count) for ``total`` pairs,
        sized by the device: a quarter of the card's memory over each pair's
        residuals, increments or path tiles and gradients, or 2e9 bytes over
        the twins' stored grids on the CPU, in equal chunks. Never pads a
        short list up to the budget. Raises, as the JAX package validates
        here, where a λ=0 shape leaves the pair list (K7) for the generic
        statics + wavefront route, and where the pair list would need the
        block propagator."""
        kind = self._solver_kind(lx1, ly1)
        if kind == "small" and not small_supported(lx1, ly1, 0, n_channels, "rbf", h):
            raise NotImplementedError(
                f"{n_channels}-channel paths of {lx1 + 1}x{ly1 + 1} nodes are "
                "outside the λ=0 pair list's envelope; the JAX package takes them by "
                "its XLA wavefront route, not ported yet (ROADMAP.md queue 1, M6)"
            )
        if kind not in ("small", "pallas"):
            raise NotImplementedError(
                f"a dyadic_order={self.dyadic_order} Gram by pair list takes the "
                "JAX package's streamed block-propagator route, not ported yet "
                "(ROADMAP.md queue 1, M6)"
            )
        if device.type == "cuda":
            budget = torch.cuda.get_device_properties(device).total_memory // 4
        else:
            budget = 2 * 10**9
        if kind == "small":
            per_pair = sigkernel_small.chunk_pair_bytes(lx1, ly1, n_channels)
        elif self._fused(lx1, ly1, n_channels, h):
            per_pair = sigkernel_fused.chunk_pair_bytes(lx1, ly1, n_channels, device.type)
        else:
            per_pair = sigkernel_tiled.chunk_pair_bytes(lx1, ly1, n_channels, device.type,
                                                        h is not None)
        nb = -(-total // max(1, min(total, budget // per_pair)))
        # equal chunks: the last one is padded by fewer than nb pairs, not by
        # up to a whole chunk of index-0 pairs (which the kernels would solve
        # and the gathers' backward would sum into one path, serially)
        return kind, -(-total // nb), nb

    @staticmethod
    def _pad_pair_list(arrays, nb, chunk, total):
        """Pad each 1-d array with zeros to ``nb·chunk`` (index 0, cotangent
        0: a padded pair adds nothing) and cut it into ``[nb, chunk]``."""
        pad = nb * chunk - total
        if pad:
            arrays = [torch.cat([a, a.new_zeros(pad)]) for a in arrays]
        return [a.reshape(nb, chunk) for a in arrays]

    def _block_values(self, X, Y, ixc, iyc, h, remat: bool = False) -> torch.Tensor:
        """K values of one pair chunk: K7 at λ=0 (``remat``: its forward
        again in the backward instead of keeping ``fac``); at λ=3 K4 (with
        K4's or K6's adjoint) inside the fused envelope, else K5 on the
        increments built in torch (linear statics, C > 8)."""
        if self.dyadic_order == 0:
            return pair_gram_small(X, Y, ixc, iyc, h, remat=remat)
        lx1, ly1, C = X.shape[1] - 1, Y.shape[1] - 1, X.shape[2]
        for prec in (self.grad_precision, "fp32"):
            if self._fused(lx1, ly1, C, h, prec):
                return pair_gram_fused(X, Y, ixc, iyc, h, grad_precision=prec)
        return pair_values(X, Y, ixc, iyc, h)

    def _pair_values(self, X, Y, ix, iy, h) -> torch.Tensor:
        """K values of the pair list ``(ix, iy)``, chunk by chunk; under
        autograd each chunk is checkpointed (its backward reruns the forward
        instead of keeping every chunk's residuals), as the JAX package's
        ``jax.checkpoint`` does: K7's Function reruns its own forward; a
        λ=3 chunk (K4, or K5 with its increments) runs under
        ``torch.utils.checkpoint``."""
        lx1, ly1 = X.shape[1] - 1, Y.shape[1] - 1
        total = ix.shape[0]
        kind, chunk, nb = self._chunk_plan(lx1, ly1, total, X.shape[2], X.device, h)
        ix, iy = self._pad_pair_list([ix, iy], nb, chunk, total)
        grad = torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (X, Y, h))
        outs = []
        for c in range(nb):
            if grad and kind == "pallas":
                outs.append(checkpoint(self._block_values, X, Y, ix[c], iy[c], h,
                                       use_reentrant=False))
            else:
                outs.append(self._block_values(X, Y, ix[c], iy[c], h, remat=grad))
        return torch.cat(outs)[:total]

    def _gram_chunked_pairs(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Streamed full Gram: nothing O(n·m·L²) is materialised; the
        bandwidth comes from the first 256×256 path block."""
        n, m = X.shape[0], Y.shape[0]
        h = self._subsampled_bandwidth(X, Y)
        idx = torch.arange(n * m, device=X.device)
        return self._pair_values(X, Y, idx // m, idx % m, h).reshape(n, m)

    def _pair_gram_and_grad(self, X: torch.Tensor, h):
        """``(K, dX)`` from the gathered upper-triangle pair list, chunk by
        chunk: the chunk's values by :meth:`_block_values` (K7's, K4's or
        K5's forward) and their gradient under autograd (K7's, K4's, K6's or
        K5's backward) with seed 1 on the diagonal and 2 off it; both
        tiles' gradients reach dX through the gathers, then ×0.5."""
        n, L, C = X.shape
        iu, ju = torch.triu_indices(n, n, device=X.device)
        total = iu.shape[0]
        _, chunk, nb = self._chunk_plan(L - 1, L - 1, total, C, X.device, h)
        seed = torch.where(iu == ju, 1.0, 2.0).to(X.dtype)
        ix, iy, sc = self._pad_pair_list([iu, ju, seed], nb, chunk, total)
        x = X.detach().requires_grad_(True)
        dX = torch.zeros_like(X)
        vals = []
        for c in range(nb):
            with torch.enable_grad():
                k = self._block_values(x, x, ix[c], iy[c], h)
                (d,) = torch.autograd.grad(k, x, sc[c])
            dX += d
            vals.append(k.detach())
        vals = torch.cat(vals)[:total]
        K = torch.empty(n, n, dtype=X.dtype, device=X.device)
        K[iu, ju] = vals
        K[ju, iu] = vals
        return K, 0.5 * dX

    def gram_sym(self, X: torch.Tensor) -> torch.Tensor:
        """Symmetric Gram ``K(X, X)`` from the ``n(n+1)/2`` upper-triangle
        pairs, with the bandwidth from the first 256×256 block.

        At λ=0 inside the JAX package's block envelope (C ≤ 8, L·C ≤ 128
        and its VMEM bound), where the JAX package takes its block values
        kernel, K3 (:func:`block_gram`) computes it: values only, with no
        autograd graph, as the JAX package's block route returns (its
        docstring promises gradients there too). Otherwise the pair list (K7 at λ=0; K4 or K5 at λ=3)
        gives the values, scattered into both halves, so gradients flow
        through both arguments: ``grad(sum(gram_sym(x)))`` is twice the
        repulsion ``grad(sum(gram(x, x.detach())))``."""
        n, L, C = X.shape
        h = self._subsampled_bandwidth(X, X)
        if (self.dyadic_order == 0 and block_values_supported(n, L, C, h)
                and jax_block_supported(n, L, C, h)
                and self._solver_kind(L - 1, L - 1) == "small"):
            with torch.no_grad():
                return block_gram(X.contiguous(), h)
        iu, ju = torch.triu_indices(n, n, device=X.device)
        vals = self._pair_values(X, X, iu, ju, h)
        K = X.new_zeros(n, n).index_put((iu, ju), vals)
        return K + torch.triu(K, 1).T

    def _subsampled_bandwidth(self, X: torch.Tensor, Y: torch.Tensor):
        """Bandwidth from the first ``256×256`` path block (the JAX
        package's documented estimate at scale); None for linear statics."""
        if self.static == "linear":
            return None
        ns, ms = min(X.shape[0], 256), min(Y.shape[0], 256)
        d2s = _pair_sq_dists(X[:ns], Y[:ms])
        return self._bandwidth_from(d2s.reshape(ns, -1))

    def _solve(self, inc: torch.Tensor) -> torch.Tensor:
        """The dense route's solve of ``inc [B, lx1, ly1]``: K8, the fp32
        block propagator, K5 (``"pallas"``), else the plain solve."""
        lx1, ly1 = inc.shape[-2:]
        lam = self.dyadic_order
        kind = self._solver_kind(lx1, ly1, dense=True)
        if kind == "mxu_chain":
            return solve_goursat_pde_mxu_chain(inc, lam, self.mxu_degree)
        if kind == "mxu":
            return solve_goursat_pde_mxu(inc, lam, self.mxu_degree)
        if kind == "pallas":
            return solve_goursat_pde_tiled(inc, lam)
        return solve_goursat_pde(inc, lam)

    def gram(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Full Gram ``K [n, m]``, differentiable. Above ``_DENSE_LIMIT``
        floats of static Gram it streams pair chunks (K7 at λ=0; K4 or K5 at
        λ=3), with a bandwidth from the first 256×256 path block. Below it,
        as the JAX package: the static Gram (the bandwidth the median over
        the whole dense distance tensor), its increments and :meth:`_solve`
        (K5 at λ=3; K8 or the fp32 propagator on block-propagator shapes;
        the plain solve at other orders)."""
        n, m = X.shape[0], Y.shape[0]
        lx1, ly1 = X.shape[1] - 1, Y.shape[1] - 1
        if n * m * X.shape[1] * Y.shape[1] > self._DENSE_LIMIT:
            return self._gram_chunked_pairs(X, Y)
        inc = gram_increments(self._static_gram(X, Y)).reshape(n * m, lx1, ly1)
        return self._solve(inc).reshape(n, m)

    def __call__(self, X: torch.Tensor, Y: torch.Tensor, **_) -> torch.Tensor:
        return self.gram(X, Y)

    def _dense_grad_ok(self, n: int, lx1: int) -> bool:
        """Whether :meth:`gram_and_grad` takes the dense full-Gram route: the
        block-propagator kinds, within the JAX package's memory guards (the
        K8 route's z/dz temporaries, the fp32 route's checkpointed hop
        inputs, each at most 3.5e9 bytes)."""
        kind = self._solver_kind(lx1, lx1)
        if kind not in ("mxu", "mxu_chain"):
            return False
        if n * n * (lx1 + 1) ** 2 > self._DENSE_LIMIT:
            return False
        if kind == "mxu_chain":
            return n * n * 128 * 4 * 2 <= 3.5e9
        m = min(64, 1 << self.dyadic_order)
        sub = (1 << self.dyadic_order) // m
        hops = (lx1 * sub) ** 2
        return n * n * hops * (2 * m + 1) * 4 * 1.5 <= 3.5e9

    def gram_and_grad(self, X: torch.Tensor):
        """``(K, Σ_j ∂₁k(x_i, x_j))``: the Gram and its gradient with the
        second argument detached. λ=0 takes K1 inside both K1's block
        envelope and the JAX package's, else the pair list (K7); λ=3 takes
        K2 at fp32 inside its envelope (RBF statics), else the pair list
        (K4, K6 at bf16, K5 for linear statics or C > 8); the kernels' plain
        twins on the CPU. Block-propagator shapes take the dense route,
        ``gram(X, X.detach())`` under autograd (K8's two kernels on the card
        at ``mxu_precision="default"``)."""
        n, L, C = X.shape
        lam = self.dyadic_order
        if lam == 3 and self.solver in ("auto", "pallas") and not pallas_supported(
                L - 1, L - 1, 3):
            # beyond JAX's λ=3 envelope (ly1 > 48) K2 still takes what fits it
            h = self._subsampled_bandwidth(X, X)
            if block3_supported(n, L, C, h):
                return block3_gram_and_grad(X, h)
        kind = self._solver_kind(L - 1, L - 1)
        if kind == "small":
            h = self._subsampled_bandwidth(X, X)
            if block_supported(n, L, C, h) and jax_block_supported(n, L, C, h):
                return block_gram_and_grad(X, h)
            return self._pair_gram_and_grad(X, h)
        if kind == "pallas":
            h = self._subsampled_bandwidth(X, X)
            if self.grad_precision == "fp32" and block3_supported(n, L, C, h):
                return block3_gram_and_grad(X, h)
            return self._pair_gram_and_grad(X, h)
        if not self._dense_grad_ok(n, L - 1):
            raise NotImplementedError(
                f"gram_and_grad of {n} paths at dyadic_order={lam} "
                "is above the dense route's memory guard; the gathered pair-list "
                "route of the block propagator is not ported yet (ROADMAP.md "
                "queue 1, M6)"
            )
        with torch.enable_grad():
            x = X.detach().requires_grad_(True)
            K = self.gram(x, X.detach())
            (dX,) = torch.autograd.grad(K.sum(), x)
        return K.detach(), dX

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
        """``4·max_pairs Σ_cells |z|³`` over the first ``n_sample`` paths, on
        the RBF or linear static Gram."""
        Xs = X[: min(n_sample, X.shape[0])]
        z = gram_increments(self._static_gram(Xs, Xs))
        return 4.0 * torch.amax(torch.sum(torch.abs(z) ** 3, dim=(-2, -1)))
