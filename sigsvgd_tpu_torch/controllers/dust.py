"""DuSt — Dual Stein variational MPC (port of
``sigsvgd_tpu/controllers/dust.py``).

Each Stein particle is a policy (an action-mean sequence over the horizon).
Every control step runs ``opt_steps`` SVGD iterations on the policies with

  * posterior ``p(θ) ∝ exp(-cost(θ)/α) · GMM-prior(θ)``,
  * the likelihood gradient from autograd through the rollout
    (``n_action_samples=0``), or the score-function estimate over
    ``n_action_samples`` reparameterised action samples ``θ + ε·Lᵀ``
    (``L`` the Cholesky factor of ``pol_cov``) with softmax weights over
    the samples,
  * costs averaged over ``n_params_samples`` draws of the uncertain
    dynamics parameters from ``params_dist`` (in log space with
    ``params_log_space``), and
  * the Stein kernel either on the policies themselves (``kernel_mode=
    "policy"``, the default: the sampler's analytic ``kernel``, through the
    fused velocity kernel K9 when ``fused_velocity``), or on the rollout
    trajectories τ (averaged over the action samples): ``"trajectory"``,
    ``kernel`` on each coordinate of τ averaged over the coordinates, or
    ``"signature"``, the signature kernel; either's gradient is pulled back
    to the policies through a second rollout of the same fixed sample
    offsets,
  * the sampler ``stein_sampler``: "SVGD", or the Gauss-Newton second-order
    "ScaledSVGD" and its preconditioned "MatrixSVGD" (which, as in the JAX
    package, take their own kernel on the policies and do not read the
    trajectory or signature kernel terms).

The first ``n_prim`` policies are frozen action primitives. After the solve
the horizon rolls by one step ("repeat", "mean" or "resample" from the
prior), optionally with the optimizer state (``roll_opt_state``), and
``weighted_prior`` keeps the policy weights as the next prior's.

Random draws come from the caller's ``torch.Generator``, or are given as
:class:`DuStDraws`; a draw needed with neither raises ``ValueError``. With
no action or parameter samples and the "repeat" or "mean" roll, ``forward``
draws nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..inference.svgd import (
    SVGD, Adam, ScaledSVGD, ScoreResult, SVGDState, roll_opt_state,
)
from ..kernels.rbf import GaussianKernel
from ..kernels.sigkernel import SignatureKernel
from ..models.base import DynamicsModel
from ..models.rollout import rollout
from ..utils import distributions as du
from ..utils.distributions import ParticleGMM
from ..utils.math import bw_median_diff, grad_gmm_log_p, pw_dist_sq, smoothed_box_log_prob

CostFn = Callable[..., torch.Tensor]


class DuStState(NamedTuple):
    pol_mean: torch.Tensor  # [n_total, H, dim_a] policy particles
    prior_weights: torch.Tensor  # [n_total] GMM prior weights
    svgd_state: SVGDState


class DuStData(NamedTuple):
    costs: torch.Tensor  # [opt_steps, (S,) n_total]
    loss: torch.Tensor  # [opt_steps, n_total]
    trace: torch.Tensor  # [opt_steps + 1, n_total, H, dim_a]
    pol_weights: torch.Tensor  # [n_total]
    trajectories: torch.Tensor  # last-iteration rollouts


class DuStDraws(NamedTuple):
    """Draws given to :meth:`DuSt.forward` in place of its generator's."""

    actions: Optional[torch.Tensor] = None  # [opt_steps, S, n_total, H, a] N(0, 1)
    params: Optional[torch.Tensor] = None  # [P, *event of params_dist] N(0, 1)
    params_comps: Optional[torch.Tensor] = None  # [P], a mixture params_dist
    roll: Optional[torch.Tensor] = None  # [n_total, H·a] N(0, 1), the resample roll
    roll_comps: Optional[torch.Tensor] = None  # [n_total], the resample roll


NO_DRAWS = DuStDraws()


@dataclasses.dataclass(frozen=True)
class DuSt:
    model: DynamicsModel
    hz_len: int
    n_pol: int  # random policies (primitives add to this)
    device: Optional[torch.device] = None  # None means "cuda"
    n_action_samples: int = 0  # 0 → autograd likelihood gradient
    n_params_samples: int = 0  # 0 → default dynamics parameters
    pol_cov: Tuple[Tuple[float, ...], ...] = ()  # [a, a]; empty = identity
    temperature: float = 1.0
    params_log_space: bool = False
    pol_hyper_prior: bool = True
    weighted_prior: bool = False
    roll_strategy: str = "repeat"  # repeat | resample | mean
    kernel_mode: str = "policy"  # policy | trajectory | signature
    kernel: Any = dataclasses.field(default_factory=GaussianKernel)
    sig_kernel: SignatureKernel = dataclasses.field(
        default_factory=lambda: SignatureKernel(dyadic_order=2)
    )
    stein_sampler: str = "SVGD"  # SVGD | ScaledSVGD | MatrixSVGD
    optimizer: Optional[Adam] = None
    lr: float = 0.1
    roll_opt_state: bool = False  # roll Adam's moments with the horizon
    fused_velocity: bool = False  # K9 for the policy-mode RBF velocity
    n_prim: int = 0  # leading policies that are frozen action primitives
    init_uniform_range: float = 10.0  # init draws stay within ± this
    inst_cost_fn: Optional[CostFn] = None
    term_cost_fn: Optional[CostFn] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.kernel_mode not in ("policy", "trajectory", "signature"):
            raise ValueError(f"Invalid kernel_mode: {self.kernel_mode}")
        if self.stein_sampler not in ("SVGD", "ScaledSVGD", "MatrixSVGD"):
            raise ValueError(f"Invalid stein_sampler: {self.stein_sampler}")
        if self.roll_strategy not in ("repeat", "resample", "mean"):
            raise ValueError(f"Invalid roll strategy: {self.roll_strategy}")

    @property
    def dim_a(self) -> int:
        return self.model.dim_a

    @property
    def n_total(self) -> int:
        return self.n_pol + self.n_prim

    def _pol_cov(self) -> torch.Tensor:
        if self.pol_cov:
            return torch.tensor(self.pol_cov, dtype=torch.float32, device=self.device)
        return torch.eye(self.dim_a, dtype=torch.float32, device=self.device)

    def _prior_var(self) -> torch.Tensor:
        """Per-dimension GMM-prior variance: diag(pol_cov) tiled over the
        horizon."""
        return torch.diag(self._pol_cov()).repeat(self.hz_len)

    def _sampler(self) -> SVGD:
        mask = None
        if self.n_prim > 0:
            mask = torch.ones((self.n_total, self.hz_len, self.dim_a),
                              dtype=torch.float32, device=self.device)
            mask[: self.n_prim] = 0.0
        log_prior = None
        space = self.model.action_space
        if self.pol_hyper_prior and space.bounded:
            low, high = space.low.to(self.device), space.high.to(self.device)

            def log_prior(pol):  # noqa: F811
                return smoothed_box_log_prob(pol, low, high, 0.1).sum(-1)

        common = dict(kernel=self.kernel, optimizer=self.optimizer, lr=self.lr,
                      log_prior=log_prior, gradient_mask=mask,
                      fused_velocity=self.fused_velocity)
        if self.stein_sampler == "SVGD":
            return SVGD(**common)
        return ScaledSVGD(precondition=self.stein_sampler == "MatrixSVGD", **common)

    def init(self, pol_mean: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             action_primitives: Optional[torch.Tensor] = None) -> DuStState:
        """Policies uniform in the (clipped) action range, drawn with
        ``generator``, unless ``pol_mean`` is given; the ``n_prim`` frozen
        ``action_primitives`` go first."""
        if pol_mean is None:
            if generator is None:
                raise ValueError("DuSt.init draws the policies: pass a "
                                 "torch.Generator or pol_mean")
            space = self.model.action_space
            low = max(max(space.low_t), -self.init_uniform_range)
            high = min(min(space.high_t), self.init_uniform_range)
            u = torch.rand((self.n_pol, self.hz_len, self.dim_a),
                           generator=generator, device=self.device)
            pol_mean = low + (high - low) * u
        if action_primitives is not None:
            if action_primitives.shape[0] != self.n_prim:
                raise ValueError(f"{action_primitives.shape[0]} action primitives "
                                 f"given, n_prim={self.n_prim}")
            pol_mean = torch.cat([action_primitives.to(pol_mean), pol_mean], dim=0)
        elif self.n_prim:
            raise ValueError("n_prim > 0 but no action_primitives given")
        return DuStState(
            pol_mean=pol_mean,
            prior_weights=torch.ones(self.n_total, dtype=torch.float32,
                                     device=self.device),
            svgd_state=self._sampler().init(pol_mean),
        )

    def _sample_params(self, params_dist, generator, draws: DuStDraws):
        """``[P, p]`` parameter samples, or None for the model's defaults
        (also when samples are asked for without a distribution)."""
        if self.n_params_samples == 0 or params_dist is None:
            return None
        P = self.n_params_samples
        mat = du.sample(params_dist, (P,), generator, eps=draws.params,
                        comps=draws.params_comps)
        mat = torch.atleast_2d(mat.reshape(P, -1))
        return torch.exp(mat) if self.params_log_space else mat

    def _params_dict(self, mat: torch.Tensor, extra_batch_dims: int):
        shape = (-1,) + (1,) * (extra_batch_dims + 1)
        return {k: v.reshape(shape) for k, v in self.model.params_to_dict(mat).items()}

    def _rollout_costs(self, state, actions, params_mat=None):
        """Roll ``[.., n_total, H, a]`` action batches; returns (costs,
        states). With parameter samples the actions roll under each, the
        costs are their mean and the states those of the first sample."""
        if params_mat is not None:
            params = self._params_dict(params_mat, actions.ndim - 2)
            acts = actions[None].expand((params_mat.shape[0],) + actions.shape)
            states = rollout(self.model, state, acts, params)
        else:
            states = rollout(self.model, state, actions)
        if self.inst_cost_fn is not None:
            inst = self.inst_cost_fn(states[..., :-1, :], actions).sum(-1)
        else:
            inst = torch.zeros(states.shape[:-2], device=states.device)
        if self.term_cost_fn is not None:
            term = self.term_cost_fn(states[..., -1, :])
        else:
            term = torch.zeros(states.shape[:-2], device=states.device)
        costs = inst + term
        if params_mat is not None:
            costs, states = costs.mean(0), states[0]
        return costs, states

    def _log_lik(self, costs: torch.Tensor) -> torch.Tensor:
        """Exponentiated utility; the min shift carries no gradient."""
        return -(costs - torch.min(costs).detach()) / self.temperature

    def _tau(self, trajs: torch.Tensor) -> torch.Tensor:
        """XY positions from t+1 on, averaged over the action samples: the
        paths the signature kernel sees."""
        tau = trajs[..., 1:, :2]
        return tau.mean(0) if self.n_action_samples > 0 else tau

    def _score(self, pol_mean, state, prior: ParticleGMM, params_mat=None,
               eps: Optional[torch.Tensor] = None):
        """Score and kernel terms of one SVGD step; ``eps [S, n_total, H, a]``
        are the step's standard normals when ``n_action_samples > 0``."""
        grad_pri = grad_gmm_log_p(
            pol_mean.reshape(self.n_total, -1), prior.means, prior.var,
            prior.weights,
        ).reshape(pol_mean.shape)

        offsets = None
        if self.n_action_samples > 0:
            if eps is None:
                raise ValueError("the score-function likelihood needs its "
                                 "action draws")
            cov = self._pol_cov()
            actions = pol_mean[None] + eps @ torch.linalg.cholesky(cov).T
            costs, trajs = self._rollout_costs(state, actions, params_mat)
            log_lik = self._log_lik(costs)
            grad_log_pol = (actions - pol_mean[None]) @ torch.linalg.inv(cov)
            w = torch.softmax(log_lik, dim=0)[..., None, None]
            grad_lik = torch.sum(w * grad_log_pol, dim=0)
            loss = -torch.sum(log_lik, dim=0)
            offsets = (actions - pol_mean[None]).detach()
        else:
            pm = pol_mean.detach().requires_grad_(True)
            with torch.enable_grad():
                costs, trajs = self._rollout_costs(state, pm, params_mat)
                (grad_lik,) = torch.autograd.grad(self._log_lik(costs).sum(), pm)
            costs, trajs = costs.detach(), trajs.detach()
            loss = -self._log_lik(costs)

        k_xx, grad_k = self._kernel_terms(pol_mean, state, params_mat, offsets, trajs)
        return ScoreResult(
            grad_log_p=grad_pri + grad_lik, k_xx=k_xx, grad_k=grad_k,
            loss=loss, aux={"costs": costs},
        ), trajs

    def _kernel_terms(self, pol_mean, state, params_mat=None, offsets=None,
                      trajs=None):
        """The kernel terms on τ, pulled back to the policies through a
        second rollout of the same fixed sample offsets, under the first
        parameter sample; in policy mode none: the sampler computes its
        analytic kernel on the policies. Signature mode: the Gram and its
        repulsion from ``gram_and_grad``, pulled back by the VJP of τ.
        Trajectory mode: ``kernel`` on each coordinate of τ against the
        detached τ of ``trajs`` (the likelihood's rollout; this rollout's
        when None), with the median bandwidth of :func:`bw_median_diff`
        unless the kernel has a ``bandwidth_fn``, averaged over the
        coordinates; the gradient of its sum by autograd."""
        if self.kernel_mode == "policy":
            return None, None
        pm = pol_mean.detach().requires_grad_(True)
        with torch.enable_grad():
            acts = pm if offsets is None else pm[None] + offsets
            if params_mat is not None:
                params = self._params_dict(params_mat[:1], acts.ndim - 2)
                rolled = rollout(self.model, state, acts[None], params)[0]
            else:
                rolled = rollout(self.model, state, acts)
            tau = self._tau(rolled)
            if self.kernel_mode == "signature":
                k_xx, dtau = self.sig_kernel.gram_and_grad(tau.detach().contiguous())
                (grad_k,) = torch.autograd.grad(tau, pm, grad_outputs=dtau)
                return k_xx, grad_k
            ref = (tau if trajs is None else self._tau(trajs)).detach()
            k = 0.0
            for i in range(tau.shape[-1]):
                h = None
                if self.kernel.bandwidth_fn is None:
                    h = bw_median_diff(pw_dist_sq(tau[..., i], ref[..., i]),
                                       self.kernel.bw_scale)
                k = k + self.kernel(tau[..., i], ref[..., i], h=h, compute_grad=False)
            k = k / tau.shape[-1]
            (grad_k,) = torch.autograd.grad(k.sum(), pm)
        return k.detach(), grad_k

    @torch.no_grad()
    def forward(self, state: torch.Tensor, ctrl: DuStState, params_dist=None,
                generator: Optional[torch.Generator] = None, opt_steps: int = 5,
                draws: DuStDraws = NO_DRAWS
                ) -> Tuple[torch.Tensor, DuStState, DuStData]:
        """One MPC solve: ``opt_steps`` SVGD iterations on the policies, pick
        the best policy, then roll the horizon. The parameter samples, each
        step's action samples and the resample roll are drawn in that order
        from ``generator``, each unless ``draws`` gives it."""
        sampler = self._sampler()
        prior = ParticleGMM(
            means=ctrl.pol_mean.reshape(self.n_total, -1),
            var=self._prior_var(),
            weights=ctrl.prior_weights,
        )
        params_mat = self._sample_params(params_dist, generator, draws)
        pol, svgd_state = ctrl.pol_mean, ctrl.svgd_state
        s_shape = (self.n_action_samples,) + tuple(pol.shape)
        costs_seq, loss_seq, trace, trajs = [], [], [pol], None
        for t in range(opt_steps):
            eps = None
            if self.n_action_samples > 0:
                eps = du.standard_normal(
                    s_shape, pol, generator,
                    None if draws.actions is None else draws.actions[t])
            score, trajs = self._score(pol, state, prior, params_mat, eps)
            pol, svgd_state = sampler.step_update(pol, svgd_state, score)
            costs_seq.append(score.aux["costs"])
            loss_seq.append(score.loss)
            trace.append(pol)

        log_lik = self._log_lik(costs_seq[-1])
        if self.n_action_samples > 0:
            log_lik = log_lik.mean(0)
        pol_weights = torch.softmax(log_lik, dim=0)
        a_seq = pol[torch.argmax(pol_weights)]

        rolled = self._roll(pol, prior, generator, draws)
        if self.roll_opt_state:
            svgd_state = SVGDState(
                opt_state=roll_opt_state(svgd_state.opt_state,
                                         (self.n_total, self.hz_len, self.dim_a)),
                step=svgd_state.step,
            )
        new_ctrl = DuStState(
            pol_mean=rolled,
            prior_weights=pol_weights if self.weighted_prior
            else torch.ones_like(pol_weights),
            svgd_state=svgd_state,
        )
        data = DuStData(
            costs=torch.stack(costs_seq), loss=torch.stack(loss_seq),
            trace=torch.stack(trace), pol_weights=pol_weights,
            trajectories=trajs,
        )
        return a_seq, new_ctrl, data

    def _roll(self, pol_mean: torch.Tensor, prior: ParticleGMM,
              generator: Optional[torch.Generator] = None,
              draws: DuStDraws = NO_DRAWS) -> torch.Tensor:
        """Shift one step along the horizon; the new last step repeats the
        old last one ("repeat"), is the policy's mean action ("mean") or the
        last step of a draw from the prior ("resample")."""
        rolled = torch.roll(pol_mean, -1, dims=-2)
        if self.roll_strategy == "repeat":
            last = rolled[..., -2, :]
        elif self.roll_strategy == "mean":
            last = pol_mean.mean(dim=-2)
        else:
            samp = du.sample(prior, (self.n_total,), generator, eps=draws.roll,
                             comps=draws.roll_comps)
            last = samp.reshape(self.n_total, self.hz_len, self.dim_a)[..., -1, :]
        rolled[..., -1, :] = last
        return rolled
