"""DISCO, information-theoretic MPC (an MPPI variant; port of
``sigsvgd_tpu/controllers/disco.py``).

The controller keeps ``n_pol`` plans ``a_mat [n_pol, H, dim_a]``. Each
solve samples ``n_actions`` perturbations per policy, rolls them through
the model (as they are, over parameter samples, or over the unscented
sigma points of the parameter distribution), softmax-weights them within
each policy against a baseline shared by all policies, updates every plan,
and forms the policy mixture weights ``a_mix`` from the per-policy
log-normalizers. ``act`` commits a plan and rolls the ensemble. The JAX
package's deliberate departures from the upstream code are kept: the
control-cost term contracts with ``+eps`` and the Monte-Carlo rollout
perturbs the per-policy plans.

Random draws come from the caller's ``torch.Generator``, or are given as
:class:`DISCODraws`; a draw needed with neither raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..models.base import DynamicsModel
from ..models.rollout import rollout
from ..utils import distributions as du
from ..utils.utf import MerweScaledUTF

CostFn = Callable[..., torch.Tensor]


class DISCOState(NamedTuple):
    a_mat: torch.Tensor  # [n_pol, H, dim_a] per-policy plans
    a_mix: torch.Tensor  # [n_pol] policy weights (softmax of log-normalizers)

    @property
    def a_seq(self) -> torch.Tensor:
        """The mixture plan ``Σ_p a_mix[p]·a_mat[p]``."""
        return torch.einsum("p,pha->ha", self.a_mix, self.a_mat)


class DISCOData(NamedTuple):
    costs: torch.Tensor  # [n_actions, n_pol]
    states: torch.Tensor  # [..., H+1, dim_s] sampled rollouts
    actions: torch.Tensor  # [n_actions, n_pol, H, dim_a]
    omega: torch.Tensor  # [n_actions, n_pol] per-policy softmax weights


class DISCODraws(NamedTuple):
    """Draws given to :meth:`DISCO.forward` in place of its generator's."""

    eps: Optional[torch.Tensor] = None  # [n_actions, n_pol, H, a] N(0, 1)
    params: Optional[torch.Tensor] = None  # [n_params, *event of params_dist] N(0, 1)
    params_comps: Optional[torch.Tensor] = None  # [n_params], a mixture params_dist


NO_DRAWS = DISCODraws()


@dataclasses.dataclass(frozen=True)
class DISCO:
    model: DynamicsModel
    hz_len: int
    n_actions: int  # sampled action sequences per policy per solve
    n_pol: int = 1  # policies in the ensemble
    device: Optional[torch.device] = None  # None means "cuda"
    pol_cov: Tuple[Tuple[float, ...], ...] = ()  # [a, a]; empty = identity
    temperature: float = 1.0
    ctrl_penalty: float = 1.0
    n_params: int = 0  # dynamics-parameter MC samples (0 = defaults)
    params_log_space: bool = False
    utf: Optional[MerweScaledUTF] = None  # sigma-point rollouts instead of MC
    inst_cost_fn: Optional[CostFn] = None
    term_cost_fn: Optional[CostFn] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def dim_a(self) -> int:
        return self.model.dim_a

    def _pol_cov(self) -> torch.Tensor:
        if self.pol_cov:
            return torch.tensor(self.pol_cov, dtype=torch.float32, device=self.device)
        return torch.eye(self.dim_a, dtype=torch.float32, device=self.device)

    def init(self, init_policy: Optional[torch.Tensor] = None) -> DISCOState:
        """Initial ensemble. ``init_policy`` may be ``[H, dim_a]`` (shared by
        the ensemble) or ``[n_pol, H, dim_a]``."""
        shape = (self.n_pol, self.hz_len, self.dim_a)
        if init_policy is None:
            a = torch.zeros(shape, dtype=torch.float32, device=self.device)
        else:
            ip = torch.as_tensor(init_policy, dtype=torch.float32).to(self.device)
            a = (ip if ip.ndim == 3 else ip[None]).expand(shape).clone()
        mix = torch.full((self.n_pol,), 1.0 / self.n_pol, dtype=torch.float32,
                         device=self.device)
        return DISCOState(a_mat=a, a_mix=mix)

    # -- cost helpers ------------------------------------------------------
    def _inst(self, states, actions):
        if self.inst_cost_fn is None:
            return torch.zeros(states.shape[:-1], dtype=states.dtype, device=states.device)
        return self.inst_cost_fn(states, actions)

    def _term(self, states):
        if self.term_cost_fn is None:
            return torch.zeros(states.shape[:-1], dtype=states.dtype, device=states.device)
        return self.term_cost_fn(states)

    def _params_dict(self, mat: torch.Tensor, extra_batch_dims: int):
        """``[k, p]`` sample matrix → parameter dict broadcastable against a
        ``[k, *batch]`` rollout."""
        shape = (-1,) + (1,) * (extra_batch_dims + 1)
        return {k: v.reshape(shape) for k, v in self.model.params_to_dict(mat).items()}

    def _costs(self, states, acts):
        inst = self._inst(states[..., :-1, :], acts).sum(-1)
        return inst + self._term(states[..., -1, :])

    # -- solve -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, state: torch.Tensor, ctrl: DISCOState, params_dist=None,
                generator: Optional[torch.Generator] = None,
                draws: DISCODraws = NO_DRAWS) -> Tuple[DISCOState, DISCOData]:
        """One MPPI update of every policy of the ensemble from ``state``.
        The perturbations, then the parameter samples, are drawn from
        ``generator``, each unless ``draws`` gives it."""
        cov = self._pol_cov()
        chol = torch.linalg.cholesky(cov)
        shape = (self.n_actions, self.n_pol, self.hz_len, self.dim_a)
        eps = du.standard_normal(shape, ctrl.a_mat, generator, draws.eps) @ chol.T
        actions = ctrl.a_mat[None] + eps  # [n, p, H, a]

        if self.utf is not None and params_dist is not None:
            states, costs = self._sigma_rollout(state, actions, params_dist)
        else:
            states, costs = self._mc_rollout(state, actions, params_dist, generator, draws)

        # control-cost term λ Σ_t u_tᵀ Σ⁻¹ ε_t with the IT-MPC paper's sign
        a_pre = torch.linalg.inv(cov)
        a_reg = self.temperature * (1.0 - self.ctrl_penalty)
        ctrl_costs = a_reg * torch.einsum("npha,pha->np", eps, ctrl.a_mat @ a_pre)
        costs = costs + ctrl_costs  # [n, p]

        # per-policy exponentiated-utility weights over a shared baseline;
        # the ensemble weights come from the per-policy log-normalizers
        beta = torch.min(costs)
        log_costs = -(costs - beta) / self.temperature  # [n, p]
        eta = torch.logsumexp(log_costs, dim=0)  # [p]
        omega = torch.exp(log_costs - eta[None])  # [n, p]
        a_mat = ctrl.a_mat + torch.einsum("np,npha->pha", omega, eps)
        a_mix = torch.softmax(eta, dim=0)
        data = DISCOData(costs=costs, states=states, actions=actions, omega=omega)
        return DISCOState(a_mat=a_mat, a_mix=a_mix), data

    def _mc_rollout(self, state, actions, params_dist, generator, draws):
        """Rollouts of ``[..., H, dim_a]`` action batches; with parameter
        samples the costs are their mean over the samples."""
        if self.n_params > 0 and params_dist is not None:
            P = self.n_params
            mat = du.sample(params_dist, (P,), generator, eps=draws.params,
                            comps=draws.params_comps)
            mat = torch.atleast_2d(mat.reshape(P, -1))
            if self.params_log_space:
                mat = torch.exp(mat)
            params = self._params_dict(mat, actions.ndim - 2)
            acts = actions[None].expand((P,) + tuple(actions.shape))  # [P, ..., H, a]
            states = rollout(self.model, state, acts, params)
            return states, self._costs(states, acts).mean(0)
        states = rollout(self.model, state, actions)
        return states, self._costs(states, actions)

    def _sigma_rollout(self, state, actions, params_dist):
        """Unscented rollouts: each action sequence under the 2p+1 sigma
        points of the parameter distribution, costs weighted by the UTF's
        location weights."""
        mean, cov = du.moments(params_dist)
        sigmas = self.utf.compute_sigma_points(mean, cov)  # [p, pts]
        params = self._params_dict(sigmas.T, actions.ndim - 2)
        acts = actions[None].expand((self.utf.pts,) + tuple(actions.shape))
        states = rollout(self.model, state, acts, params)
        costs = self._costs(states, acts)  # [pts, ...]
        return states, torch.tensordot(self.utf.loc_weights.to(costs), costs, dims=1)

    # -- act ---------------------------------------------------------------
    def act(self, ctrl: DISCOState, steps: int = 1, strategy: str = "average",
            data: Optional[DISCOData] = None,
            ext_actions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, DISCOState]:
        """Commit a plan, emit its next ``steps`` actions (clipped to the
        action space), roll every plan of the ensemble (zero fill).

        ``average``: the ``a_mix``-weighted mixture of the plans;
        ``argmax``: the plan of the highest-weight policy; ``best_sample``:
        the last solve's sampled sequence of largest omega (needs ``data``;
        omega is normalised per policy, so with ``n_pol > 1`` this is not
        the best sample overall, as in the JAX package); ``external``:
        ``ext_actions`` as given."""
        if strategy == "average":
            a_seq = ctrl.a_seq
        elif strategy == "argmax":
            a_seq = ctrl.a_mat[torch.argmax(ctrl.a_mix)]
        elif strategy == "best_sample":
            if data is None:
                raise ValueError("best_sample strategy needs the solve's data")
            flat = data.omega.reshape(-1)
            acts = data.actions.reshape(flat.shape[0], self.hz_len, self.dim_a)
            a_seq = acts[torch.argmax(flat)]
        elif strategy == "external":
            if ext_actions is None:
                raise ValueError("external strategy needs ext_actions")
            a_seq = ext_actions
        else:
            raise ValueError(f"Invalid strategy: {strategy}")
        a_seq = self.model.action_space.clip(a_seq)
        next_actions = a_seq[:steps]
        rolled = torch.roll(ctrl.a_mat, -steps, dims=1)
        rolled[:, -steps:] = 0.0
        return next_actions, DISCOState(a_mat=rolled, a_mix=ctrl.a_mix)
