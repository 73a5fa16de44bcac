"""Sharded DuSt MPC solve: the policy particles over a mesh (port of
``sigsvgd_tpu/parallel/dust.py``).

One MPC solve with the policies sharded over 'dp': rollouts, costs,
likelihood gradients and the optimizer updates are local to each rank; the
global couplings are a few collectives a Stein step:

  * a gather of the initial policies and prior weights, for the GMM prior,
  * the kernel terms: in policy mode gathered particle rows and Gram rows
    (``parallel.svgd._velocity_local``); in the trajectory and signature
    modes gathered τ projections, each rank solving its ``[n_local, N]``
    (or 2-D ``[n_local, N/sp]``) Gram block and pulling the kernel gradient
    back through its own rollouts, or the ring or the balanced triangle of
    ``gram_mode``,
  * min, sum and argmax reductions for the final softmax policy weights.

Every single-device DuSt option runs: the three kernel modes, the autograd
and Monte-Carlo likelihood gradients, parameter samples, frozen primitives
(the gradient mask sliced per rank), the weighted prior, the three horizon
rolls and ``roll_opt_state``. Random draws mirror the single-device
:meth:`DuSt.forward`: every rank draws the full tensor from its generator
(each rank's seeded alike) or takes it from ``draws``, and slices its own
rows, so results match the single-device solve to fp tolerance. The velocity
is the first-order Stein velocity with the sampler's kernel, as in the JAX
package's sharded solve. Adam, the raw ``lr`` update and Adagrad update
locally; L-BFGS's line search is not sharded and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..controllers.dust import NO_DRAWS, DuSt, DuStDraws, DuStState
from ..inference.svgd import LBFGS, ScoreResult, SVGDState, roll_opt_state
from ..kernels.sigkernel_block import block_tiles_ks_partial
from ..kernels.sigkernel_block3 import block3_tiles_ks_partial
from ..models.rollout import rollout
from ..utils import distributions as du
from ..utils.math import bw_from_median, grad_gmm_log_p, pw_dist_sq
from . import comm
from .mesh import axis_group, axis_index, axis_size
from .svgd import _column_block, _velocity_local, distributed_median_diff

_TILE_PARTIALS = {"k1": block_tiles_ks_partial, "k2": block3_tiles_ks_partial}


def _triangle_groups(n_total: int, ndev: int) -> int:
    """Row-group count ``g`` of the triangle Gram decomposition (the JAX
    package's rule): ``2·ndev`` (or ``ndev`` when that does not divide), made
    finer while each group keeps at least 64 rows and divides ``n_total``.
    Finer groups shrink the diagonal blocks' extra work (each (a, a) block
    solves its whole square) and the imbalance of dealing g(g+1)/2 equal
    blocks round-robin to ``ndev`` ranks."""
    best = 2 * ndev if n_total % (2 * ndev) == 0 else ndev
    m = best // ndev + 1
    while m * ndev * 64 <= n_total:
        if n_total % (m * ndev) == 0:
            best = m * ndev
        m += 1
    return best


def triangle_blocks(n_total: int, ndev: int, rank: int):
    """Rank ``rank``'s blocks ``(a, b)``, a ≤ b, of the ``g`` row groups of
    :func:`_triangle_groups`, dealt round-robin in row-major order (the JAX
    package's assignment without its zero-weight padding)."""
    g = _triangle_groups(n_total, ndev)
    blocks = [(a, b) for a in range(g) for b in range(a, g)]
    return blocks[rank::ndev]


@torch.no_grad()
def sharded_dust_forward(ctrl: DuSt, state: torch.Tensor, cstate: DuStState,
                         generator: Optional[torch.Generator], opt_steps: int,
                         mesh: DeviceMesh, axis: str = "dp",
                         col_axis: Optional[str] = None, params_dist=None,
                         gram_mode: str = "auto", draws: DuStDraws = NO_DRAWS
                         ) -> Tuple[torch.Tensor, DuStState]:
    """One sharded MPC solve on every rank of ``mesh``.

    ``cstate`` holds this rank's rows: ``pol_mean [n_local, H, a]``,
    ``prior_weights [n_local]`` and the optimizer leaves whose leading dim is
    the particles'; ``state`` is replicated. Returns the best policy's
    actions (replicated) and the next state's rows.

    ``gram_mode`` picks the signature Gram's decomposition (all equal to the
    single device up to fp summation order):

      * ``"triangle"`` (the 1-D default in signature mode): balanced
        upper-triangle blocks, half the PDE work of full row blocks. Where
        the single-device ``gram_and_grad`` takes a block kernel (K1 at λ=0,
        K2 at λ=3), each rank launches it over every ndev-th tile of its
        tile list and one pair of all-reduces sums the ``K@s`` and pull-back
        partials; otherwise blocks of row groups (:func:`triangle_blocks`).
      * ``"ring"``: the Gram in ``ndev`` column chunks while the (τ, score)
        chunks move one rank along a ring; no gather of τ (but for a median
        bandwidth).
      * ``"gather"``: τ gathered up front, full ``[n_local, N]`` (or 2-D
        ``[n_local, N/sp]`` with ``col_axis``) row blocks by autograd.

    Signature modes with a median bandwidth take the single device's
    ``_subsampled_bandwidth`` of the gathered τ (no gradient flows through
    it there either); the trajectory mode's median over the sharded
    distance blocks is differentiable (``distributed_median_diff``), as
    ``bw_median_diff`` is on one device."""
    if ctrl.kernel_mode not in ("policy", "trajectory", "signature"):
        raise ValueError(f"Invalid kernel_mode: {ctrl.kernel_mode}")
    if gram_mode == "auto":
        gram_mode = ("triangle" if ctrl.kernel_mode == "signature" and col_axis is None
                     else "gather")
    if gram_mode not in ("gather", "ring", "triangle"):
        raise ValueError(f"Invalid gram_mode: {gram_mode}")
    if gram_mode != "gather" and (ctrl.kernel_mode != "signature" or col_axis is not None):
        raise ValueError("ring/triangle Gram decompositions apply to the 1-D "
                         "sharded signature mode")
    if isinstance(ctrl.optimizer, LBFGS):
        raise ValueError("the sharded solve takes Adam or the raw lr update; "
                         "L-BFGS's line search is not sharded")
    ndev = axis_size(mesh, axis)
    dp = axis_group(mesh, axis)
    rank = axis_index(mesh, axis)
    n_local = cstate.pol_mean.shape[0]
    n_total = n_local * ndev
    if n_total != ctrl.n_total:
        raise ValueError(f"{ndev} ranks of {n_local} policies, the controller has "
                         f"{ctrl.n_total}")
    if col_axis is not None and n_total % axis_size(mesh, col_axis):
        raise ValueError(f"n_total ({n_total}) must divide the '{col_axis}' axis "
                         f"({axis_size(mesh, col_axis)})")
    row0 = rank * n_local
    rows = slice(row0, row0 + n_local)

    sampler = ctrl._sampler()
    if sampler.gradient_mask is not None:
        sampler = dataclasses.replace(sampler, gradient_mask=sampler.gradient_mask[rows])
    prior_var = ctrl._prior_var()
    S = ctrl.n_action_samples
    cov = ctrl._pol_cov()
    chol = torch.linalg.cholesky(cov)
    pre = torch.linalg.inv(cov)

    # the GMM prior sits at the solve's initial policies: one gather of the
    # policies with their prior weights
    pol = cstate.pol_mean
    both = comm.all_gather(torch.cat([pol.reshape(n_local, -1),
                                      cstate.prior_weights[:, None]], dim=1), dp)
    prior_means, prior_weights = both[:, :-1], both[:, -1]
    params_mat = ctrl._sample_params(params_dist, generator, draws)

    def tau_of(pm, offsets):
        """τ of a rollout of ``pm`` (plus the fixed sample offsets), under
        the first parameter sample, as ``DuSt._kernel_terms`` rolls it."""
        acts = pm if offsets is None else pm[None] + offsets
        if params_mat is not None:
            params = ctrl._params_dict(params_mat[:1], acts.ndim - 2)
            rolled = rollout(ctrl.model, state, acts[None], params)[0]
        else:
            rolled = rollout(ctrl.model, state, acts)
        return ctrl._tau(rolled)

    def sig_with_bw(tau_all):
        sig = ctrl.sig_kernel
        if sig.bandwidth is not None or sig.static == "linear":
            return sig
        h = sig._subsampled_bandwidth(tau_all, tau_all)
        return dataclasses.replace(sig, bandwidth=float(h))

    def traj_h(t, ref_cols, dim):
        if ctrl.kernel.bandwidth_fn is not None:
            return None
        d2 = pw_dist_sq(t[..., dim].reshape(t.shape[0], -1),
                        ref_cols[..., dim].reshape(ref_cols.shape[0], -1))
        axes = axis if col_axis is None else (axis, col_axis)
        med = distributed_median_diff(d2, mesh, axes)
        return bw_from_median(med, n_total, ctrl.kernel.bw_scale)

    def kernel_terms(pol, trajs, offsets):
        """Gram block and pull-back gradient of the local rows against the
        gathered τ of the likelihood's rollouts."""
        tau_all = comm.all_gather(ctrl._tau(trajs), dp)
        tau_cols = _column_block(tau_all, mesh, col_axis).contiguous()
        sig = sig_with_bw(tau_all)
        with torch.enable_grad():
            pm = pol.detach().requires_grad_(True)
            t = tau_of(pm, offsets)
            if ctrl.kernel_mode == "signature":
                k = sig.gram(t.contiguous(), tau_cols)
            else:
                k = 0.0
                for i in range(t.shape[-1]):
                    k = k + ctrl.kernel(t[..., i], tau_cols[..., i],
                                        h=traj_h(t, tau_cols, i), compute_grad=False)
                k = k / t.shape[-1]
            (grad_k,) = torch.autograd.grad(k.sum(), pm)
        return k.detach(), grad_k

    def ring_terms(pol, offsets, s_local):
        """``ks = Σ_c K(τ_rows, τ_c) s_c`` while the (τ, score) chunks move
        along the ring, and the repulsion pulled back through the rows."""
        with torch.enable_grad():
            pm = pol.detach().requires_grad_(True)
            tau_rows = tau_of(pm, offsets)
        sig = ctrl.sig_kernel
        if sig.bandwidth is None and sig.static != "linear":
            sig = sig_with_bw(comm.all_gather(tau_rows.detach(), dp))
        rows_t = tau_rows.detach().contiguous()
        chunk_tau, chunk_s = rows_t, s_local
        ks = torch.zeros_like(s_local)
        dtau = torch.zeros_like(rows_t)
        for step in range(ndev):
            with torch.enable_grad():
                tr = rows_t.clone().requires_grad_(True)
                k_blk = sig.gram(tr, chunk_tau)
                (d,) = torch.autograd.grad(k_blk.sum(), tr)
            ks = ks + k_blk.detach() @ chunk_s
            dtau = dtau + d
            if step < ndev - 1:  # the last chunk needs no further move
                chunk_tau, chunk_s = comm.ring_shift([chunk_tau, chunk_s], dp)
        (grad_k,) = torch.autograd.grad(tau_rows, pm, grad_outputs=dtau)
        return ks, grad_k

    def triangle_terms(pol, offsets, s_local):
        """The upper-triangle Gram split over the ranks: tile subsets of K1
        or K2 where the single device takes them, else blocks of row groups,
        each block's value feeding both groups' ``K@s`` and its two-argument
        gradient both groups' repulsion. One all-reduce pair sums the
        partials; each rank pulls its rows back through its rollout."""
        with torch.enable_grad():
            pm = pol.detach().requires_grad_(True)
            tau_rows = tau_of(pm, offsets)
        tau_all = comm.all_gather(tau_rows.detach(), dp).contiguous()
        s_all = comm.all_gather(s_local, dp)
        sig = sig_with_bw(tau_all)
        L, C = tau_all.shape[1], tau_all.shape[2]
        route = (sig._block_route(n_total, L, C, sig.bandwidth)
                 if sig.static == "rbf" else None)
        if route is not None:
            ks_acc, dtau_acc = _TILE_PARTIALS[route](tau_all, sig.bandwidth, s_all,
                                                     ndev, rank)
        else:
            ng = n_total // _triangle_groups(n_total, ndev)
            ks_acc = torch.zeros_like(s_all)
            dtau_acc = torch.zeros_like(tau_all)
            for a, b in triangle_blocks(n_total, ndev, rank):
                ra, rb = slice(a * ng, (a + 1) * ng), slice(b * ng, (b + 1) * ng)
                with torch.enable_grad():
                    ta = tau_all[ra].clone().requires_grad_(True)
                    tb = tau_all[rb].clone().requires_grad_(a != b)
                    k_blk = sig.gram(ta, tb)
                    grads = torch.autograd.grad(k_blk.sum(), [ta, tb] if a != b else [ta])
                k_blk = k_blk.detach()
                ks_acc[ra] += k_blk @ s_all[rb]
                dtau_acc[ra] += grads[0]
                if a != b:  # a diagonal block counts once
                    ks_acc[rb] += k_blk.T @ s_all[ra]
                    dtau_acc[rb] += grads[1]
        ks = comm.all_reduce(ks_acc, "sum", dp)[rows]
        dtau = comm.all_reduce(dtau_acc, "sum", dp)[rows]
        (grad_k,) = torch.autograd.grad(tau_rows, pm, grad_outputs=dtau)
        return ks, grad_k

    opt_state = cstate.svgd_state.opt_state
    zero_step = torch.zeros((), dtype=torch.int32, device=pol.device)
    costs_seq = []
    for t in range(opt_steps):
        offsets = None
        if S > 0:
            eps = du.standard_normal((S, n_total) + tuple(pol.shape[1:]), pol, generator,
                                     None if draws.actions is None else draws.actions[t])
            actions = pol[None] + eps[:, rows] @ chol.T
            costs, trajs = ctrl._rollout_costs(state, actions, params_mat)
            w = torch.softmax(ctrl._log_lik(costs), dim=0)[..., None, None]
            grad_lik = torch.sum(w * ((actions - pol[None]) @ pre), dim=0)
            offsets = (actions - pol[None]).detach()
        else:
            pm = pol.detach().requires_grad_(True)
            with torch.enable_grad():
                costs, trajs = ctrl._rollout_costs(state, pm, params_mat)
                (grad_lik,) = torch.autograd.grad(ctrl._log_lik(costs).sum(), pm)
            costs, trajs = costs.detach(), trajs.detach()
        grad_pri = grad_gmm_log_p(pol.reshape(n_local, -1), prior_means, prior_var,
                                  prior_weights).reshape(pol.shape)

        if gram_mode in ("ring", "triangle"):
            s_full = grad_pri + grad_lik
            if sampler.log_prior is not None:
                with torch.enable_grad():
                    xx = pol.detach().requires_grad_(True)
                    (pg,) = torch.autograd.grad(sampler.log_prior(xx).sum(), xx)
                s_full = s_full + pg
            terms = ring_terms if gram_mode == "ring" else triangle_terms
            ks, grad_kp = terms(pol, offsets, s_full.reshape(n_local, -1))
            gk = grad_kp.reshape(n_local, -1)
            if sampler.repulsion_schedule is not None:
                gk = gk * sampler.repulsion_schedule(zero_step)
            phi = ((ks - gk) / n_total).reshape(pol.shape)
            if sampler.gradient_mask is not None:
                phi = phi * sampler.gradient_mask
        else:
            k_rows = grad_k = None
            if ctrl.kernel_mode != "policy":
                k_rows, grad_k = kernel_terms(pol, trajs, offsets)
            score = ScoreResult(grad_log_p=grad_pri + grad_lik, k_xx=k_rows, grad_k=grad_k,
                                loss=costs)
            phi, _ = _velocity_local(sampler, pol, score, zero_step, mesh, axis, col_axis)
        pol, opt_state = sampler.apply_update(pol, -phi, opt_state)
        costs_seq.append(costs)

    # global softmax policy weights from the last iteration's costs
    last = costs_seq[-1]
    if S > 0:
        last = last.mean(dim=0)
    gmin = comm.all_reduce(torch.min(last), "min", dp)
    logits = -(last - gmin) / ctrl.temperature
    z = comm.all_reduce(torch.sum(torch.exp(logits)), "sum", dp)
    weights_local = torch.exp(logits) / z
    # the best policy: the lowest global index among ties, as argmax
    best = torch.argmax(weights_local)
    gmax = comm.all_reduce(weights_local[best], "max", dp)
    cand = torch.where(weights_local[best] == gmax, row0 + best,
                       torch.tensor(n_total, device=best.device))
    owner = comm.all_reduce(cand, "min", dp)
    a_seq = comm.all_reduce(pol[best] * (row0 + best == owner).to(pol.dtype), "sum", dp)

    # the horizon roll (DuSt._roll)
    rolled = torch.roll(pol, -1, dims=-2)
    if ctrl.roll_strategy == "repeat":
        last_step = rolled[..., -2, :]
    elif ctrl.roll_strategy == "mean":
        last_step = pol.mean(dim=-2)
    else:
        prior = du.ParticleGMM(means=prior_means, var=prior_var, weights=prior_weights)
        samp = du.sample(prior, (n_total,), generator, eps=draws.roll, comps=draws.roll_comps)
        last_step = samp.reshape(n_total, ctrl.hz_len, ctrl.dim_a)[rows][..., -1, :]
    rolled[..., -1, :] = last_step
    if ctrl.roll_opt_state:
        opt_state = roll_opt_state(opt_state, tuple(pol.shape))
    new = DuStState(
        pol_mean=rolled,
        prior_weights=weights_local if ctrl.weighted_prior else torch.ones_like(weights_local),
        svgd_state=SVGDState(opt_state=opt_state,
                             step=cstate.svgd_state.step + opt_steps),
    )
    return a_seq, new


def make_sharded_mpc_step(ctrl: DuSt, mesh: DeviceMesh, opt_steps: int, axis: str = "dp",
                          col_axis: Optional[str] = None, params_dist=None,
                          gram_mode: str = "auto"):
    """A closed-loop step: the sharded solve, then the model's transition
    under the first action (replicated on every rank)."""

    def step(state, cstate, generator=None, draws: DuStDraws = NO_DRAWS):
        a_seq, cstate = sharded_dust_forward(ctrl, state, cstate, generator, opt_steps, mesh,
                                             axis, col_axis, params_dist, gram_mode, draws)
        nxt = ctrl.model.step(state[None], a_seq[0:1])[0]
        return nxt, cstate, a_seq

    return step
