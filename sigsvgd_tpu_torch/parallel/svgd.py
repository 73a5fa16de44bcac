"""Sharded SVGD: particles over a mesh axis, collectives on
``torch.distributed`` (port of ``sigsvgd_tpu/parallel/svgd.py``).

The velocity ``φ = (K s − ∇K)/N`` is a row-sharded matmul: each rank owns a
block of particles, gathers the (small) particle and score tensors, forms
its ``[n_local, N]`` Gram rows and its own kernel gradients, and updates its
particles locally. Costs and scores are local to the rank's block.

Sharded score functions return LOCAL ROWS: ``grad_log_p [n_local, ...]``,
optionally ``k_xx [n_local, N]`` (Gram rows, or ``[n_local, N/sp]`` with a
column axis) and ``grad_k [n_local, ...]``. Every function here runs on
every rank of the mesh's group.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..inference.score import _detach
from ..inference.svgd import SVGD, ScoreResult, SVGDState
from ..kernels.sigkernel import SignatureKernel
from ..utils.math import bw_from_median, pw_dist_sq
from . import comm
from .mesh import Axes, axis_group, axis_index, axis_size


def distributed_median(vals_local: torch.Tensor, mesh: DeviceMesh, axes: Axes = "dp",
                       iters: int = 40) -> torch.Tensor:
    """Exact median of values sharded over ``axes`` (one mesh dim or a tuple
    for 2-D pair-grid blocks): bisection on the value range with summed rank
    counts, ``iters`` scalar all-reduces instead of a gather, then a snap to
    the smallest element above the lower bound, the kth order statistic
    once the interval has collapsed. The lower middle for even counts, as
    ``torch.median`` and ``utils.math.bw_median``. No gradient."""
    group = axis_group(mesh, axes)
    v = vals_local.detach().reshape(-1)
    n_total = v.shape[0] * axis_size(mesh, axes)
    k = (n_total - 1) // 2
    lo = comm.all_reduce(torch.min(v), "min", group) - 1.0
    hi = comm.all_reduce(torch.max(v), "max", group)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = comm.all_reduce(torch.sum(v <= mid), "sum", group)
        go_down = cnt >= k + 1
        lo, hi = torch.where(go_down, lo, mid), torch.where(go_down, mid, hi)
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    cand = torch.min(torch.where(v > lo, v, inf))
    return comm.all_reduce(cand, "min", group)


def distributed_median_diff(vals_local: torch.Tensor, mesh: DeviceMesh,
                            axes: Axes = "dp", iters: int = 40) -> torch.Tensor:
    """:func:`distributed_median`'s value, differentiable: the gradient goes
    to one element equal to it, the first local match on the lowest mesh
    position that holds one, through a sum over the ranks whose backward
    sums the cotangents (``comm.all_reduce_sum_diff``)."""
    group = axis_group(mesh, axes)
    v = vals_local.reshape(-1)
    vs = v.detach()
    med = distributed_median(vs, mesh, axes, iters)
    hit = vs == med
    pos = axis_index(mesh, axes)
    ndev = axis_size(mesh, axes)
    mine = torch.where(hit.any(), torch.tensor(pos, device=v.device),
                       torch.tensor(ndev, device=v.device))
    owner = comm.all_reduce(mine, "min", group)
    idx = torch.argmax(hit.to(torch.uint8))
    sel = torch.where(owner == pos, v[idx], torch.zeros((), dtype=v.dtype, device=v.device))
    return comm.all_reduce_sum_diff(sel, group)


def _column_block(t: torch.Tensor, mesh: DeviceMesh, col_axis: Optional[str]):
    """This rank's column block of a gathered ``[N, ...]`` tensor (all of it
    without a column axis)."""
    if col_axis is None:
        return t
    sp = axis_size(mesh, col_axis)
    if t.shape[0] % sp:
        raise ValueError(f"{t.shape[0]} columns do not divide the '{col_axis}' axis ({sp})")
    cols = t.shape[0] // sp
    c0 = axis_index(mesh, col_axis) * cols
    return t[c0:c0 + cols]


def _velocity_local(svgd: SVGD, x_local: torch.Tensor, score: ScoreResult, step,
                    mesh: DeviceMesh, axis: str = "dp", col_axis: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stein velocity of this rank's particles. With ``col_axis`` each rank
    owns a ``[n_local, N/sp]`` block of the Gram: rows follow the particle
    axis, columns the ``col_axis`` split, and ``K @ s`` and the kernel
    gradient are summed over ``col_axis``."""
    n_local = x_local.shape[0]
    xf = x_local.reshape(n_local, -1)
    s = score.grad_log_p.reshape(n_local, -1)
    if svgd.log_prior is not None:
        with torch.enable_grad():
            xx = x_local.detach().requires_grad_(True)
            (prior_grad,) = torch.autograd.grad(svgd.log_prior(xx).sum(), xx)
        s = s + prior_grad.reshape(n_local, -1)
    dp = axis_group(mesh, axis)
    s_all = comm.all_gather(s, dp)
    n_total = s_all.shape[0]
    s_cols = _column_block(s_all, mesh, col_axis)

    if score.k_xx is not None and score.grad_k is not None:
        k_rows = score.k_xx
        grad_k = score.grad_k.reshape(n_local, -1)
    else:
        x_cols = _column_block(comm.all_gather(xf, dp), mesh, col_axis)
        d2 = pw_dist_sq(xf, x_cols)
        if svgd.kernel.bandwidth_fn is not None:
            h = svgd.kernel.bandwidth(d2)
        else:
            # the exact median over the global d² matrix: every rank's
            # Gram block must use one bandwidth
            axes = axis if col_axis is None else (axis, col_axis)
            med = distributed_median(d2, mesh, axes)
            h = bw_from_median(med, n_total, svgd.kernel.bw_scale)
        k_rows, grad_k = svgd.kernel(xf, x_cols, h=h)

    ks = k_rows @ s_cols
    if col_axis is not None:
        sp = axis_group(mesh, col_axis)
        ks = comm.all_reduce(ks, "sum", sp)
        grad_k = comm.all_reduce(grad_k, "sum", sp)
    if svgd.repulsion_schedule is not None:
        grad_k = grad_k * svgd.repulsion_schedule(step)
    phi = ((ks - grad_k) / n_total).reshape(x_local.shape)
    if svgd.gradient_mask is not None:
        phi = phi * svgd.gradient_mask  # the caller passes the local mask block
    loss = score.loss if score.loss is not None else torch.linalg.norm(s)
    return phi, loss


@torch.no_grad()
def sharded_svgd_run(svgd: SVGD, particles_local: torch.Tensor,
                     score_fn: Callable, n_steps: int, mesh: DeviceMesh,
                     generator: Optional[torch.Generator] = None, axis: str = "dp",
                     col_axis: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` of SVGD with the particles sharded over ``mesh[axis]``:
    ``particles_local`` is this rank's block (replicated over ``col_axis``).
    ``score_fn(x_local, generator)`` scores the block and may itself use
    collectives (:func:`sharded_pathsig_score`); a rank's generator must
    draw what every other rank's draws. Returns this rank's final block and
    the per-step global losses ``[n_steps]``; the same as the single-device
    :meth:`SVGD.run` up to fp summation order."""
    n_total = particles_local.shape[0] * axis_size(mesh, axis)
    if col_axis is not None and n_total % axis_size(mesh, col_axis):
        raise ValueError(f"{n_total} particles do not divide the '{col_axis}' axis")
    dp = axis_group(mesh, axis)
    x = particles_local
    state = svgd.init(x)
    losses = []
    for _ in range(n_steps):
        score = score_fn(x, generator)
        phi, loss = _velocity_local(svgd, x, score, state.step, mesh, axis, col_axis)
        x, opt_state = svgd.apply_update(x, -phi, state.opt_state)
        state = SVGDState(opt_state, state.step + 1)
        losses.append(comm.all_reduce(torch.sum(torch.atleast_1d(loss)), "sum", dp))
    return x, (torch.stack(losses) if losses
               else torch.zeros(0, device=particles_local.device))


def sharded_pathsig_score(cost_fn: Callable, sig_kernel: SignatureKernel,
                          mesh: DeviceMesh, axis: str = "dp",
                          paths_of: Optional[Callable] = None,
                          col_axis: Optional[str] = None):
    """Signature-kernel score with a row-sharded Gram: each rank gathers the
    path tensor, solves its ``[n_local, N]`` block of pairs (``gram`` of its
    rows against all paths: K8 on the card at block-propagator orders with
    ``mxu_precision="default"``) and differentiates the block sum by its own
    particles, the rows the sharded velocity needs. One gather of ``[N, L,
    C]`` paths a step. ``paths_of`` maps particles to paths (the particles
    by default); with ``col_axis`` the pair grid is 2-D sharded. The kernel
    needs a fixed bandwidth (or linear statics): a median per block would
    differ between ranks."""
    if sig_kernel.bandwidth is None and sig_kernel.static != "linear":
        raise ValueError("the sharded signature score needs a fixed bandwidth")
    paths_of = paths_of or (lambda x: x)

    def score(x_local, generator=None):
        with torch.enable_grad():
            xl = x_local.detach().requires_grad_(True)
            cost, aux = cost_fn(xl)
            (grad_c,) = torch.autograd.grad(cost.sum(), xl)
        tau_all = comm.all_gather(paths_of(x_local).detach(), axis_group(mesh, axis))
        tau_cols = _column_block(tau_all, mesh, col_axis).contiguous()
        with torch.enable_grad():
            xl = x_local.detach().requires_grad_(True)
            k_rows = sig_kernel.gram(paths_of(xl), tau_cols)
            (grad_k,) = torch.autograd.grad(k_rows.sum(), xl)
        return ScoreResult(grad_log_p=-grad_c, k_xx=k_rows.detach(), grad_k=grad_k,
                           loss=cost.detach(), aux=_detach(aux))

    return score

