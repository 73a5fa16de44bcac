"""Untruncated signature kernel via the Goursat PDE (port of
``sigsvgd_tpu/kernels/sigkernel.py``).

Discretisation, as the JAX package: with ``z = inc / 4^λ``,

    k[i+1,j+1] = (k[i+1,j] + k[i,j+1])·(1 + z/2 + z²/12) − k[i,j]·(1 − z²/12)

where ``inc`` is the double difference of the static Gram (RBF, or linear
with ``static="linear"``) on the coarse grid.

Routing (``SignatureKernel._solver_kind``), as the JAX package routes on the
TPU (``solver="auto"``; the explicit solvers as the JAX package maps them):
λ=0 with ly1 ≤ 63 and RBF statics → the ``"small"`` kind:
``gram_and_grad`` takes ``sigkernel_block.block_gram_and_grad`` (K1) inside
the JAX package's block envelope (C ≤ 8, L·C ≤ 128 and its VMEM bound),
which K1's holds, as the JAX package takes its block kernel there (the
planner's ``[n, 3, 7]`` knots included), else the gathered upper-triangle
pair list through ``sigkernel_small`` (K7's forward and backward: L·C >
128 or C > 8), and ``gram`` above ``_DENSE_LIMIT`` streams pair chunks
through K7; ``gram_sym`` takes ``sigkernel_block.block_gram`` (K3) inside
the same envelope, where the JAX package takes its block values kernel,
else the upper-triangle pair list. λ=3 with ly1 ≤ 48 → the ``"pallas"``
kind: ``gram_and_grad`` takes ``sigkernel_block3.block3_gram_and_grad``
(K2) at ``grad_precision="fp32"`` inside K2's envelope (RBF statics; C ≤ 3
at L ≤ 64, or C ≤ 8 with L·C ≤ 128, which holds the JAX package's block3
envelope), else the gathered upper-triangle pair list (L·C > 128 at C > 3,
or the bf16 adjoint); a pair list takes ``sigkernel_fused`` inside the
fused envelope (RBF statics, C ≤ 8: K4's forward, then K4's fp32 backward or, at
``grad_precision="bf16"`` inside JAX's bf16 envelope, K6), else
``sigkernel_tiled.pair_values`` (linear statics or C > 8: the increments in
torch, K5's forward and backward); ``gram`` above ``_DENSE_LIMIT`` streams
pair chunks through those pair lists, and the dense λ=3 ``gram`` solves its
increments by K5 (``solve_goursat_pde_tiled``). Shapes the block propagator
takes (λ ≥ 4, at most 256 block hops) → the hop chain K8
(``mxu_chain.solve_goursat_pde_mxu_chain``) when ``mxu_precision="default"``
and K8 takes the shape, else the fp32 block propagator
:func:`solve_goursat_pde_mxu`. Each kernel runs its plain twin on the CPU.
Every other shape takes the ``"wavefront"`` kind, as the JAX package's
XLA route (λ = 1 and 2, DuSt's default order; λ=0 with linear statics or
beyond K7's envelope; λ=3 beyond ly1 = 48 outside K2; λ ≥ 4 beyond 256
block hops; ``solver="wavefront"``): the statics and increments in torch
and :func:`solve_goursat_pde`, an anti-diagonal sweep of torch ops with a
chunked, checkpointed adjoint (no kernel of its own: the JAX package
computes it in XLA, outside any Pallas kernel); the dense λ=0 ``gram``
solves by it too. The block-propagator kinds take a pair list where the
dense route does not fit: ``gram`` above ``_DENSE_LIMIT`` streams pair
chunks and ``gram_and_grad`` above :meth:`SignatureKernel._dense_grad_ok`
takes the gathered upper-triangle pair list; each chunk's statics and
increments are built in torch and solved by K8 (``"mxu_chain"``) or the
fp32 block propagator (``"mxu"``), the chunk under
``torch.utils.checkpoint``.
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
from .sigkernel_tiled import pair_increments, pair_values, solve_goursat_pde_tiled

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


# ---------------------------------------------------------------------------
# Goursat-PDE wavefront (the JAX package's XLA route). Node diagonal s holds
# the nodes (i, s - i); its interior nodes, i in [max(1, s - gy), min(gx,
# s - 1)], are one contiguous slice of a [B, gx + 1] row, and each reads
# slots i and i - 1 of diagonal s - 1 and slot i - 1 of diagonal s - 2. The
# coarse cell of each interior node is gathered from a flat index built
# once a shape on the device; nothing inside the sweep syncs with the host.
# Rows are pair-minor (``[gx + 1, B]``), so each gather and slice moves
# whole runs of pairs. A node is ``fma(left + up, A, -(corner·B))``, one rounding where XLA's
# CPU and TPU code contract it (``torch.addcmul`` is that fused multiply-add
# on the CPU); the coefficient fields carry -B.
# ---------------------------------------------------------------------------

_SEG = 48  # diagonals between the backward's checkpoints


def solve_goursat_pde_scan(inc: torch.Tensor, dyadic_order: int = 0) -> torch.Tensor:
    """``inc [B, lx1, ly1] → [B]``, the JAX package's ``lax.scan`` over the
    anti-diagonals step for step (the whole ``[B, gx + 1]`` diagonal, rolled
    neighbours, non-interior nodes masked to 1), out of place and
    differentiable by autograd, which keeps every diagonal: the oracle of
    :func:`solve_goursat_pde`, for small batches. Each node is the fused
    ``fma(left + up, A, -(corner·B))`` XLA makes of the JAX step."""
    b, lx1, ly1 = inc.shape
    lam = dyadic_order
    z = (inc / float(4 ** lam)).reshape(b, -1)
    a_f = 1.0 + 0.5 * z + z * z * (1.0 / 12.0)
    b_f = 1.0 - z * z * (1.0 / 12.0)
    gx, gy = lx1 << lam, ly1 << lam
    ii = torch.arange(gx + 1, device=inc.device)
    dm2 = dm1 = torch.ones(b, gx + 1, dtype=inc.dtype, device=inc.device)
    for s in range(2, gx + gy + 1):
        jj = s - ii
        interior = (ii >= 1) & (ii <= gx) & (jj >= 1) & (jj <= gy)
        flat = ((ii - 1).clamp(0, gx - 1) >> lam) * ly1 + ((jj - 1).clamp(0, gy - 1) >> lam)
        new = torch.addcmul(-(torch.roll(dm2, 1, dims=1) * b_f[:, flat]),
                            dm1 + torch.roll(dm1, 1, dims=1), a_f[:, flat])
        dm2, dm1 = dm1, torch.where(interior[None, :], new, 1.0)
    return dm1[:, gx]


@lru_cache(maxsize=32)
def _wavefront_plan(lx1: int, ly1: int, lam: int, device: str):
    """``(spans, idx)``: for each node diagonal s = 2..gx+gy its interior
    ``(lo, hi, off)``, and on ``device`` the flat coarse cell ``ci·ly1 +
    cj`` of every interior node, diagonal after diagonal (diagonal s's at
    ``idx[off:off + hi - lo + 1]``)."""
    gx, gy = lx1 << lam, ly1 << lam
    spans, cells, off = [], [], 0
    for s in range(2, gx + gy + 1):
        lo, hi = max(1, s - gy), min(gx, s - 1)
        i = np.arange(lo, hi + 1)
        cells.append(((i - 1) >> lam) * ly1 + ((s - i - 1) >> lam))
        spans.append((lo, hi, off))
        off += hi - lo + 1
    idx = np.concatenate(cells) if cells else np.zeros(0, np.int64)
    return spans, torch.from_numpy(idx.astype(np.int64)).to(device)


def _fields(z: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """``[fields, cells, B]`` from the scaled increments ``z [lx1, ly1, B]``:
    A and -B (rounded as :func:`solve_goursat_pde_scan` rounds A and B), and
    for the adjoint z/6 and ½ + z/6. A diagonal gathers whole rows of each
    field apart (:func:`_rows`)."""
    z = z.reshape(-1, z.shape[-1])
    f = z.new_empty(4 if adjoint else 2, *z.shape)
    zz = z * z
    torch.add(1.0 + 0.5 * z, zz * (1.0 / 12.0), out=f[0])
    torch.sub(zz * (1.0 / 12.0), 1.0, out=f[1])
    if adjoint:
        torch.div(z, 6.0, out=f[2])
        torch.add(f[2], 0.5, out=f[3])
    return f


def _rows(f: torch.Tensor, idx: torch.Tensor, fields: int):
    """Rows ``idx`` of the first ``fields`` fields of ``f``, each gathered
    from its own contiguous ``[cells, B]`` block (on the card a gather of
    whole rows along dim 0 runs vectorised; along dim 1 it does not)."""
    return [f[k].index_select(0, idx) for k in range(fields)]


def _wavefront_sweep(z: torch.Tensor, lam: int, checkpoints: bool = False):
    """The forward sweep of one chunk of scaled increments ``z [lx1, ly1,
    B]``: ``k [B]``, and with ``checkpoints`` the diagonals ``(s0 - 2, s0 -
    1)`` at each segment start ``s0 = 2 + q·_SEG`` (``[n_seg, 2, gx + 1,
    B]``). Diagonals are ``[gx + 1, B]``, pair-minor."""
    lx1, ly1, b = z.shape
    gx, gy = lx1 << lam, ly1 << lam
    spans, idx = _wavefront_plan(lx1, ly1, lam, str(z.device))
    ab = _fields(z)
    bufs = [z.new_ones(gx + 1, b) for _ in range(3)]
    n_seg = -(-len(spans) // _SEG)
    ck = z.new_empty(n_seg, 2, gx + 1, b) if checkpoints else None
    for t, (lo, hi, off) in enumerate(spans):
        s = t + 2
        if checkpoints and t % _SEG == 0:
            ck[t // _SEG, 0].copy_(bufs[(s - 2) % 3])
            ck[t // _SEG, 1].copy_(bufs[(s - 1) % 3])
        c = _rows(ab, idx[off:off + hi - lo + 1], 2)
        p1, p2 = bufs[(s - 1) % 3], bufs[(s - 2) % 3]
        torch.addcmul(p2[lo - 1:hi] * c[1], p1[lo:hi + 1] + p1[lo - 1:hi], c[0],
                      out=bufs[s % 3][lo:hi + 1])
    return bufs[(gx + gy) % 3][gx].clone(), ck


def _wavefront_adjoint(z: torch.Tensor, lam: int, g_out: torch.Tensor) -> torch.Tensor:
    """``d(Σ g_out·k)/dz`` of one chunk, ``[lx1, ly1, B]``. The forward
    sweep keeps a checkpoint every ``_SEG`` diagonals; then, segment by
    segment from the last, the segment's diagonals are recomputed from its
    checkpoint (so the adjoint reads exactly the forward's values: no
    reconstruction in reverse, no division by ``1 − z²/12``) and the adjoint
    runs back over them: ``g_s[i] = u_{s+1}[i] + u_{s+1}[i+1] −
    v_{s+2}[i+1]`` with ``u = A·g`` and ``v = B·g`` on each diagonal's
    interior (zero elsewhere; -v is kept), each node's ``∂k/∂z = (left +
    up)(½ + z/6) + corner·z/6`` times its adjoint summed into its coarse
    cell, one scatter-add a segment. Memory is O(B·G) a chunk: the
    checkpoints, one segment's diagonals and its cell terms."""
    lx1, ly1, b = z.shape
    gx, gy = lx1 << lam, ly1 << lam
    s_last = gx + gy
    spans, idx = _wavefront_plan(lx1, ly1, lam, str(z.device))
    _, ck = _wavefront_sweep(z, lam, checkpoints=True)
    abz = _fields(z, adjoint=True)
    dz = z.new_zeros(lx1 * ly1, b)
    U = [z.new_zeros(gx + 2, b) for _ in range(3)]  # u_s on row i of U[s % 3]
    V = [z.new_zeros(gx + 2, b) for _ in range(3)]  # -v_s likewise
    D = z.new_empty(_SEG + 2, gx + 1, b)            # one segment's diagonals
    for q in reversed(range(ck.shape[0])):
        s0 = 2 + q * _SEG
        s1 = min(s0 + _SEG, s_last + 1)
        D.fill_(1.0)
        D[0].copy_(ck[q, 0])
        D[1].copy_(ck[q, 1])
        for s in range(s0, s1):
            lo, hi, off = spans[s - 2]
            c = _rows(abz, idx[off:off + hi - lo + 1], 2)
            p1, p2 = D[s - s0 + 1], D[s - s0]
            torch.addcmul(p2[lo - 1:hi] * c[1], p1[lo:hi + 1] + p1[lo - 1:hi], c[0],
                          out=D[s - s0 + 2][lo:hi + 1])
        seg_off = spans[s0 - 2][2]
        lo, hi, off = spans[s1 - 3]
        seg_end = off + hi - lo + 1
        dzs = z.new_empty(seg_end - seg_off, b)
        for s in range(s1 - 1, s0 - 1, -1):
            lo, hi, off = spans[s - 2]
            n = hi - lo + 1
            c = _rows(abz, idx[off:off + n], 4)
            u1, v2 = U[(s + 1) % 3], V[(s + 2) % 3]
            g = u1[lo:hi + 1] + u1[lo + 1:hi + 2] + v2[lo + 1:hi + 2]
            if s == s_last:
                g = g + g_out[None, :]
            p1, p2 = D[s - s0 + 1], D[s - s0]
            torch.mul(g, (p1[lo:hi + 1] + p1[lo - 1:hi]) * c[3] + p2[lo - 1:hi] * c[2],
                      out=dzs[off - seg_off:off - seg_off + n])
            torch.mul(c[0], g, out=U[s % 3][lo:hi + 1])
            torch.mul(c[1], g, out=V[s % 3][lo:hi + 1])
        dz.index_add_(0, idx[seg_off:seg_end], dzs)
    return dz.reshape(lx1, ly1, b)


class _Wavefront(torch.autograd.Function):
    """One chunk of the wavefront with its memory-bounded adjoint, on scaled
    increments ``z [lx1, ly1, B]`` (pair-minor, the layout of K5's ``z``);
    the forward keeps only ``z``."""

    @staticmethod
    def forward(ctx, z, lam):
        ctx.save_for_backward(z)
        ctx.lam = lam
        return _wavefront_sweep(z, lam)[0]

    @staticmethod
    def backward(ctx, g_out):
        (z,) = ctx.saved_tensors
        return _wavefront_adjoint(z, ctx.lam, g_out.contiguous()), None


def wavefront_pair_bytes(lx1: int, ly1: int, dyadic_order: int,
                         n_channels: Optional[int] = None) -> int:
    """Memory the wavefront's adjoint holds for one pair of a chunk: the
    saved increments, the coefficient fields, the cell terms, the
    checkpoints, one segment's diagonals and cell terms, the adjoint rows
    and a diagonal's temporaries; with ``n_channels`` also a pair list's
    statics (the gathered paths, ``[L, L']`` fields and their gradients)."""
    gx = lx1 << dyadic_order
    w = gx + 1
    cells = lx1 * ly1
    n_seg = -(-(gx + (ly1 << dyadic_order) - 1) // _SEG)
    floats = 10 * cells + 2 * n_seg * w + (2 * _SEG + 2) * w + 24 * w
    if n_channels is not None:
        floats += 8 * (lx1 + 1) * (ly1 + 1) + 4 * (lx1 + ly1 + 2) * n_channels
    return 4 * floats


def _budget_bytes(device) -> int:
    """A chunk's memory budget: a quarter of the card's memory on CUDA, 2e9
    bytes on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return 2 * 10**9


def auto_chunk(lx1: int, ly1: int, dyadic_order: int, budget_bytes: Optional[int] = None,
               device="cpu") -> int:
    """Pairs a wavefront chunk takes: ``budget_bytes`` (by default
    :func:`_budget_bytes` of ``device``) over :func:`wavefront_pair_bytes`,
    at least 256."""
    if budget_bytes is None:
        budget_bytes = _budget_bytes(device)
    return max(256, budget_bytes // wavefront_pair_bytes(lx1, ly1, dyadic_order))


def solve_goursat_pde(inc: torch.Tensor, dyadic_order: int = 0,
                      chunk: Optional[int] = None) -> torch.Tensor:
    """The production wavefront solve ``inc [B, lx1, ly1] → [B]`` for any
    dyadic order, ``chunk`` pairs at a time (:func:`auto_chunk` when None;
    the last chunk is short, never padded). Each chunk, scaled by ``4^-λ``
    and made pair-minor by torch ops, goes through a
    ``torch.autograd.Function`` that keeps only its increments and whose
    backward runs in O(chunk·G) memory (:func:`_wavefront_adjoint`). Values
    and gradients are those of :func:`solve_goursat_pde_scan`."""
    b, lx1, ly1 = inc.shape
    if lx1 == 0 or ly1 == 0:
        return inc.new_ones(b) + 0.0 * inc.sum(dim=(1, 2))
    if chunk is None:
        chunk = auto_chunk(lx1, ly1, dyadic_order, device=inc.device)
    scale = float(4 ** dyadic_order)
    return torch.cat([
        _Wavefront.apply((c / scale).permute(1, 2, 0).contiguous(), dyadic_order)
        for c in inc.split(max(1, int(chunk)))
    ])


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


def mxu_pair_bytes(kind: str, lx1: int, ly1: int, dyadic_order: int, n_channels: int,
                   degree: int = 10) -> int:
    """Memory one pair of a block-propagator chunk holds: the gathered paths
    and their gradients (``4(lx1+ly1+2)·C`` floats), the static Gram, its
    distances and their gradients (``4(lx1+1)(ly1+1)``), the increments,
    and the solve's own state. K8 (``"mxu_chain"``) keeps z and dz, two
    ``lx1·ly1`` floats (the JAX package counts ``2·(128 + 2·lx1·ly1)``
    floats for its lane-padded relayouts, ``sigkernel.py:671-675``); the
    fp32 propagator (``"mxu"``) keeps each hop's checkpointed input, the
    live rows and one hop's ``[D+1, 2m+1]`` temporary, twice for headroom,
    as the JAX package counts it (``:676-686``)."""
    floats = 4 * (lx1 + ly1 + 2) * n_channels + 4 * (lx1 + 1) * (ly1 + 1) + lx1 * ly1
    if kind == "mxu_chain":
        floats += 2 * lx1 * ly1
    else:
        m = min(64, 1 << dyadic_order)
        sub = (1 << dyadic_order) // m
        nbx, nby = lx1 * sub, ly1 * sub
        floats += 2 * (nbx * nby * (2 * m + 1) + nbx * (m + 1) + (degree + 1) * (2 * m + 1))
    return 4 * floats


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
        fp32 block propagator; "wavefront" the wavefront solve
        (:func:`solve_goursat_pde`) at every shape.
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

    def _solver_kind(self, lx1: int, ly1: int) -> str:
        """``"small"`` (λ=0, ly1 ≤ 63, RBF statics: K1 or K3 on a block, else
        the K7 pair list), ``"pallas"`` (λ=3, ly1 ≤ 48: K2, the K4/K6 pair
        list or K5), ``"mxu_chain"`` (K8), ``"mxu"`` (the fp32 block
        propagator) or ``"wavefront"`` (:func:`solve_goursat_pde`, statics
        in torch), as the JAX package maps ``solver`` on the TPU."""
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
        return "wavefront"

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
        residuals, increments or path tiles and gradients (the wavefront's
        adjoint working set and statics), or 2e9 bytes over the twins'
        stored grids on the CPU, in equal chunks. Never pads a short list up
        to the budget. As the JAX package validates here, a λ=0 shape
        outside the pair list's envelope (K7) takes the wavefront kind. The
        block-propagator kinds are sized by :func:`mxu_pair_bytes`."""
        kind = self._solver_kind(lx1, ly1)
        if kind == "small" and not small_supported(lx1, ly1, 0, n_channels, "rbf", h):
            kind = "wavefront"
        budget = _budget_bytes(device)
        if kind == "small":
            per_pair = sigkernel_small.chunk_pair_bytes(lx1, ly1, n_channels)
        elif kind == "wavefront":
            per_pair = wavefront_pair_bytes(lx1, ly1, self.dyadic_order, n_channels)
        elif kind in ("mxu_chain", "mxu"):
            per_pair = mxu_pair_bytes(kind, lx1, ly1, self.dyadic_order, n_channels,
                                      self.mxu_degree)
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

    def _block_values(self, X, Y, ixc, iyc, h, kind: str,
                      remat: bool = False) -> torch.Tensor:
        """K values of one pair chunk of solver ``kind``: K7 (``"small"``;
        ``remat``: its forward again in the backward instead of keeping
        ``fac``); at λ=3 (``"pallas"``) K4 (with K4's or K6's adjoint)
        inside the fused envelope, else K5 on the increments built in torch
        (linear statics, C > 8); ``"wavefront"``: the increments of the
        gathered paths built in torch as for K5 (``pair_increments``), then
        the wavefront in one chunk; ``"mxu_chain"`` and ``"mxu"``: the same
        increments unscaled, pair-major, then K8 or the fp32 block
        propagator."""
        if kind == "small":
            return pair_gram_small(X, Y, ixc, iyc, h, remat=remat)
        if kind == "wavefront":
            return _Wavefront.apply(
                pair_increments(X, Y, ixc, iyc, h, self.dyadic_order), self.dyadic_order)
        if kind in ("mxu_chain", "mxu"):
            inc = pair_increments(X, Y, ixc, iyc, h, 0).permute(2, 0, 1).contiguous()
            if kind == "mxu_chain":
                return solve_goursat_pde_mxu_chain(inc, self.dyadic_order, self.mxu_degree)
            return solve_goursat_pde_mxu(inc, self.dyadic_order, self.mxu_degree)
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
        λ=3 chunk (K4, or K5 with its increments) and a wavefront chunk (its
        statics and solve) run under ``torch.utils.checkpoint``."""
        lx1, ly1 = X.shape[1] - 1, Y.shape[1] - 1
        total = ix.shape[0]
        kind, chunk, nb = self._chunk_plan(lx1, ly1, total, X.shape[2], X.device, h)
        ix, iy = self._pad_pair_list([ix, iy], nb, chunk, total)
        grad = torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (X, Y, h))
        outs = []
        for c in range(nb):
            if grad and kind != "small":
                outs.append(checkpoint(self._block_values, X, Y, ix[c], iy[c], h, kind,
                                       use_reentrant=False))
            else:
                outs.append(self._block_values(X, Y, ix[c], iy[c], h, kind, remat=grad))
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
        chunk: the chunk's values by :meth:`_block_values` (K7's, K4's, K5's
        or the wavefront's forward) and their gradient under autograd (K7's,
        K4's, K6's, K5's or the wavefront's backward) with seed 1 on the
        diagonal and 2 off it; both tiles' gradients reach dX through the
        gathers, then ×0.5."""
        n, L, C = X.shape
        iu, ju = torch.triu_indices(n, n, device=X.device)
        total = iu.shape[0]
        kind, chunk, nb = self._chunk_plan(L - 1, L - 1, total, C, X.device, h)
        seed = torch.where(iu == ju, 1.0, 2.0).to(X.dtype)
        ix, iy, sc = self._pad_pair_list([iu, ju, seed], nb, chunk, total)
        x = X.detach().requires_grad_(True)
        dX = torch.zeros_like(X)
        vals = []
        for c in range(nb):
            with torch.enable_grad():
                k = self._block_values(x, x, ix[c], iy[c], h, kind)
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
        block propagator, K5 (``"pallas"``), else (the ``"small"`` and
        ``"wavefront"`` kinds, as the JAX package's ``_solve``) the
        wavefront in :func:`auto_chunk` chunks."""
        lx1, ly1 = inc.shape[-2:]
        lam = self.dyadic_order
        kind = self._solver_kind(lx1, ly1)
        if kind == "mxu_chain":
            return solve_goursat_pde_mxu_chain(inc, lam, self.mxu_degree)
        if kind == "mxu":
            return solve_goursat_pde_mxu(inc, lam, self.mxu_degree)
        if kind == "pallas":
            return solve_goursat_pde_tiled(inc, lam)
        return solve_goursat_pde(inc, lam, auto_chunk(lx1, ly1, lam, device=inc.device))

    def gram(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Full Gram ``K [n, m]``, differentiable. Above ``_DENSE_LIMIT``
        floats of static Gram it streams pair chunks (K7 at λ=0; K4 or K5 at
        λ=3; K8 or the fp32 block propagator at λ ≥ 4), with a bandwidth from the first 256×256 path block. Below it,
        as the JAX package: the static Gram (the bandwidth the median over
        the whole dense distance tensor), its increments and :meth:`_solve`
        (K5 at λ=3; K8 or the fp32 propagator on block-propagator shapes;
        the wavefront at other orders)."""
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
        twins on the CPU. The wavefront kind (λ = 1, 2; λ=0 with linear
        statics or beyond K7's envelope; λ=3 beyond ly1 = 48 outside K2;
        ``solver="wavefront"``) takes the pair list with the wavefront's
        adjoint. Block-propagator shapes take the dense route,
        ``gram(X, X.detach())`` under autograd (K8's two kernels on the card
        at ``mxu_precision="default"``), within :meth:`_dense_grad_ok`'s
        memory guard, else the pair list (K8 or the fp32 block propagator
        a chunk)."""
        n, L, C = X.shape
        if (self._solver_kind(L - 1, L - 1) in ("mxu", "mxu_chain")
                and self._dense_grad_ok(n, L - 1)):
            with torch.enable_grad():
                x = X.detach().requires_grad_(True)
                K = self.gram(x, X.detach())
                (dX,) = torch.autograd.grad(K.sum(), x)
            return K.detach(), dX
        h = self._subsampled_bandwidth(X, X)
        route = self._block_route(n, L, C, h)
        if route == "k1":
            return block_gram_and_grad(X, h)
        if route == "k2":
            return block3_gram_and_grad(X, h)
        return self._pair_gram_and_grad(X, h)

    def _block_route(self, n: int, L: int, C: int, h) -> Optional[str]:
        """The block kernel :meth:`gram_and_grad` takes for ``[n, L, C]``
        paths at bandwidth ``h``: ``"k1"`` (λ=0, the ``"small"`` kind, inside
        both K1's block envelope and the JAX package's), ``"k2"`` (λ=3 at
        ``grad_precision="fp32"`` inside K2's envelope: the ``"pallas"``
        kind, or beyond JAX's ly1 ≤ 48 under the λ=3 solvers), or None (a
        pair list or the dense route). The sharded triangle solve runs the
        same kernel on its tile subsets (``parallel.dust``)."""
        kind = self._solver_kind(L - 1, L - 1)
        if (self.dyadic_order == 3 and self.solver in ("auto", "pallas")
                and not pallas_supported(L - 1, L - 1, 3)):
            return "k2" if block3_supported(n, L, C, h) else None
        if (kind == "small" and block_supported(n, L, C, h)
                and jax_block_supported(n, L, C, h)):
            return "k1"
        if (kind == "pallas" and self.grad_precision == "fp32"
                and block3_supported(n, L, C, h)):
            return "k2"
        return None

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
