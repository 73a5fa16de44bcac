"""DuSt — Dual Stein variational MPC (port of
``sigsvgd_tpu/controllers/dust.py``, policy and signature-kernel modes).

Each Stein particle is a policy (an action-mean sequence over the horizon).
Every control step runs ``opt_steps`` SVGD iterations on the policies with

  * posterior ``p(θ) ∝ exp(-cost(θ)/α) · GMM-prior(θ)``,
  * the likelihood gradient from autograd through the rollout, and
  * the Stein kernel either on the policies themselves (``kernel_mode=
    "policy"``, the default: the sampler's analytic ``kernel``, through the
    fused velocity kernel K9 when ``fused_velocity``), or the signature
    kernel on the rollout trajectories (``"signature"``), its gradient
    pulled back to the policies through a second rollout.

``forward`` draws nothing: with ``n_action_samples=0``, no parameter
distribution and the "repeat" roll it is deterministic given its state.
The trajectory kernel mode, action and parameter sampling, the other Stein
samplers and roll strategies raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..inference.svgd import SVGD, Adam, ScoreResult, SVGDState
from ..kernels.rbf import GaussianKernel
from ..kernels.sigkernel import SignatureKernel
from ..models.base import DynamicsModel
from ..models.rollout import rollout
from ..utils.distributions import ParticleGMM
from ..utils.math import grad_gmm_log_p, smoothed_box_log_prob

CostFn = Callable[..., torch.Tensor]


class DuStState(NamedTuple):
    pol_mean: torch.Tensor  # [n_pol, H, dim_a] policy particles
    prior_weights: torch.Tensor  # [n_pol] GMM prior weights
    svgd_state: SVGDState


class DuStData(NamedTuple):
    costs: torch.Tensor  # [opt_steps, n_pol]
    loss: torch.Tensor  # [opt_steps, n_pol]
    trace: torch.Tensor  # [opt_steps + 1, n_pol, H, dim_a]
    pol_weights: torch.Tensor  # [n_pol]
    trajectories: torch.Tensor  # last-iteration rollouts


@dataclasses.dataclass(frozen=True)
class DuSt:
    model: DynamicsModel
    hz_len: int
    n_pol: int
    device: Optional[torch.device] = None  # None means "cuda"
    n_action_samples: int = 0
    n_params_samples: int = 0
    pol_cov: Tuple[Tuple[float, ...], ...] = ()  # [a, a]; empty = identity
    temperature: float = 1.0
    params_log_space: bool = False
    pol_hyper_prior: bool = True
    weighted_prior: bool = False
    roll_strategy: str = "repeat"
    kernel_mode: str = "policy"  # policy | signature (trajectory: M8)
    kernel: Any = dataclasses.field(default_factory=GaussianKernel)
    sig_kernel: SignatureKernel = dataclasses.field(
        default_factory=lambda: SignatureKernel(dyadic_order=2)
    )
    stein_sampler: str = "SVGD"
    optimizer: Optional[Adam] = None
    lr: float = 0.1
    roll_opt_state: bool = False
    fused_velocity: bool = False  # K9 for the policy-mode RBF velocity
    n_prim: int = 0
    init_uniform_range: float = 10.0  # init draws stay within ± this
    inst_cost_fn: Optional[CostFn] = None
    term_cost_fn: Optional[CostFn] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        unported = {
            "kernel_mode": (self.kernel_mode not in ("policy", "signature"),
                            "the trajectory mode: queue 1, M8"),
            "n_action_samples": (self.n_action_samples > 0,
                                 "the score-function likelihood: queue 1, M8"),
            "n_params_samples": (self.n_params_samples > 0,
                                 "parameter sampling: queue 1, M8"),
            "stein_sampler": (self.stein_sampler != "SVGD",
                              "ScaledSVGD/MatrixSVGD: queue 1, M7"),
            "roll_strategy": (self.roll_strategy != "repeat",
                              "resample and mean rolls: queue 1, M1 and M8"),
            "pol_cov": (self.pol_cov != (),
                        "the policy covariance, with the score-function likelihood: "
                        "queue 1, M8"),
            "params_log_space": (self.params_log_space,
                                 "parameter sampling: queue 1, M8"),
            "weighted_prior": (self.weighted_prior, "weighted_prior: queue 1, M8"),
            "roll_opt_state": (self.roll_opt_state,
                               "roll_opt_state: queue 1, M8 and M7's roll_leaf"),
            "n_prim": (self.n_prim != 0,
                       "frozen primitives: queue 1, M8 and M7's gradient_mask"),
        }
        for name, (bad, item) in unported.items():
            if bad:
                raise NotImplementedError(
                    f"DuSt {name}={getattr(self, name)!r} is not ported yet "
                    f"({item} in ROADMAP.md)"
                )

    @property
    def dim_a(self) -> int:
        return self.model.dim_a

    def _prior_var(self) -> torch.Tensor:
        """Per-dimension GMM-prior variance: the identity policy covariance
        tiled over the horizon."""
        return torch.ones(self.hz_len * self.dim_a, dtype=torch.float32,
                          device=self.device)

    def _sampler(self) -> SVGD:
        log_prior = None
        space = self.model.action_space
        if self.pol_hyper_prior and space.bounded:
            low, high = space.low.to(self.device), space.high.to(self.device)

            def log_prior(pol):  # noqa: F811
                return smoothed_box_log_prob(pol, low, high, 0.1).sum(-1)

        return SVGD(kernel=self.kernel, optimizer=self.optimizer, lr=self.lr,
                    log_prior=log_prior, fused_velocity=self.fused_velocity)

    def init(self, pol_mean: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> DuStState:
        """Policies uniform in the (clipped) action range, drawn with
        ``generator``, unless ``pol_mean`` is given."""
        if pol_mean is None:
            space = self.model.action_space
            low = max(max(space.low_t), -self.init_uniform_range)
            high = min(min(space.high_t), self.init_uniform_range)
            u = torch.rand((self.n_pol, self.hz_len, self.dim_a),
                           generator=generator, device=self.device)
            pol_mean = low + (high - low) * u
        return DuStState(
            pol_mean=pol_mean,
            prior_weights=torch.ones(self.n_pol, dtype=torch.float32,
                                     device=self.device),
            svgd_state=self._sampler().init(pol_mean),
        )

    def _rollout_costs(self, state, actions):
        """Roll ``[n_pol, H, a]`` action batches; returns (costs, states)."""
        states = rollout(self.model, state, actions)
        if self.inst_cost_fn is not None:
            inst = self.inst_cost_fn(states[..., :-1, :], actions).sum(-1)
        else:
            inst = torch.zeros(states.shape[:-2], device=states.device)
        if self.term_cost_fn is not None:
            term = self.term_cost_fn(states[..., -1, :])
        else:
            term = torch.zeros(states.shape[:-2], device=states.device)
        return inst + term, states

    def _log_lik(self, costs: torch.Tensor) -> torch.Tensor:
        """Exponentiated utility; the min shift carries no gradient."""
        return -(costs - torch.min(costs).detach()) / self.temperature

    def _tau(self, trajs: torch.Tensor) -> torch.Tensor:
        """XY positions from t+1 on: the paths the signature kernel sees."""
        return trajs[..., 1:, :2]

    def _score(self, pol_mean, state, prior: ParticleGMM):
        grad_pri = grad_gmm_log_p(
            pol_mean.reshape(self.n_pol, -1), prior.means, prior.var,
            prior.weights,
        ).reshape(pol_mean.shape)

        pm = pol_mean.detach().requires_grad_(True)
        with torch.enable_grad():
            costs, trajs = self._rollout_costs(state, pm)
            (grad_lik,) = torch.autograd.grad(self._log_lik(costs).sum(), pm)
        costs, trajs = costs.detach(), trajs.detach()
        loss = -self._log_lik(costs)

        k_xx, grad_k = self._kernel_terms(pol_mean, state)
        return ScoreResult(
            grad_log_p=grad_pri + grad_lik, k_xx=k_xx, grad_k=grad_k,
            loss=loss, aux={"costs": costs},
        ), trajs

    def _kernel_terms(self, pol_mean, state):
        """Signature Gram and its repulsion on τ, pulled back to the
        policies through a second rollout (the VJP of τ); in policy mode
        none: the sampler computes its analytic kernel on the policies."""
        if self.kernel_mode == "policy":
            return None, None
        pm = pol_mean.detach().requires_grad_(True)
        with torch.enable_grad():
            tau = self._tau(rollout(self.model, state, pm))
            k_xx, dtau = self.sig_kernel.gram_and_grad(tau.detach().contiguous())
            (grad_k,) = torch.autograd.grad(tau, pm, grad_outputs=dtau)
        return k_xx, grad_k

    @torch.no_grad()
    def forward(self, state: torch.Tensor, ctrl: DuStState,
                opt_steps: int = 5) -> Tuple[torch.Tensor, DuStState, DuStData]:
        """One MPC solve: ``opt_steps`` SVGD iterations on the policies, pick
        the best policy, then roll the horizon."""
        sampler = self._sampler()
        prior = ParticleGMM(
            means=ctrl.pol_mean.reshape(self.n_pol, -1),
            var=self._prior_var(),
            weights=ctrl.prior_weights,
        )
        pol, svgd_state = ctrl.pol_mean, ctrl.svgd_state
        costs_seq, loss_seq, trace, trajs = [], [], [pol], None
        for _ in range(opt_steps):
            score, trajs = self._score(pol, state, prior)
            pol, svgd_state = sampler.step_update(pol, svgd_state, score)
            costs_seq.append(score.aux["costs"])
            loss_seq.append(score.loss)
            trace.append(pol)

        pol_weights = torch.softmax(self._log_lik(costs_seq[-1]), dim=0)
        a_seq = pol[torch.argmax(pol_weights)]
        new_ctrl = DuStState(
            pol_mean=self._roll(pol), prior_weights=torch.ones_like(pol_weights),
            svgd_state=svgd_state,
        )
        data = DuStData(
            costs=torch.stack(costs_seq), loss=torch.stack(loss_seq),
            trace=torch.stack(trace), pol_weights=pol_weights,
            trajectories=trajs,
        )
        return a_seq, new_ctrl, data

    def _roll(self, pol_mean: torch.Tensor) -> torch.Tensor:
        """Shift one step along the horizon and repeat the last action."""
        rolled = torch.roll(pol_mean, -1, dims=-2)
        rolled[..., -1, :] = rolled[..., -2, :]
        return rolled
