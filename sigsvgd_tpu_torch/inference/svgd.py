"""Stein variational gradient descent (port of
``sigsvgd_tpu/inference/svgd.py``: SVGD, ScaledSVGD and MatrixSVGD).

Update rule: with score ``s_i = ∇ log p(x_i)`` and aggregated kernel
gradient ``g_i = Σ_j ∂k(x_i, x_j)/∂x_i``,

    φ_i = (Σ_j k_ij s_j − g_i) / n          (Stein velocity, ascent direction)
    x_i ← optimizer_update(x_i, −φ_i)        (descent on −φ)

The kernel terms come with the score (``ScoreResult.k_xx``/``grad_k``,
trajectory and signature modes) or from the sampler's own analytic kernel
on the particles (policy mode), optionally through the fused velocity
kernel (K9). ``repulsion_schedule(step)`` scales the kernel gradient and
``gradient_mask`` multiplies φ (frozen particles). The update is Adam, the
hand-rolled Adagrad or the raw ``lr`` step; :func:`roll_opt_state` shifts
the optimizer state with a receding horizon. :meth:`SVGD.run` and
:meth:`SVGD.run_host_loop` are the same Python loop over the steps
(PyTorch runs eagerly); they differ in what they log, as in the JAX
package. :class:`ScaledSVGD` is the second-order sampler with a
Gauss-Newton metric (:func:`matrix_svgd` preconditions by it). LBFGS is a
later slice (ROADMAP.md queue 1, M10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..kernels.rbf import GaussianKernel, ScaledGaussianKernel
from ..kernels.svgd_velocity import fused_rbf_velocity
from ..utils.math import pw_dist_sq


class ScoreResult(NamedTuple):
    grad_log_p: torch.Tensor
    k_xx: Optional[torch.Tensor] = None
    grad_k: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None
    aux: Any = None


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: torch.Tensor
    nu: torch.Tensor


class SVGDState(NamedTuple):
    opt_state: Any  # AdamState, or () for the raw lr update
    step: torch.Tensor


class RunData(NamedTuple):
    trace: torch.Tensor  # [n_steps + 1, n, ...] particle trajectory
    loss: torch.Tensor  # [n_steps, ...] per-step losses
    aux: Any  # the score's aux, stacked over the steps


ScoreFn = Callable[[torch.Tensor, Optional[torch.Generator]], ScoreResult]


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam`` exactly: ``μ←b1·μ+(1−b1)g``, ``ν←b2·ν+(1−b2)g²``,
    bias-corrected, ``Δ = −lr·μ̂/(√(ν̂ + eps_root) + eps)``."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, x: torch.Tensor) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=x.device),
            mu=torch.zeros_like(x),
            nu=torch.zeros_like(x),
        )

    def update(self, g: torch.Tensor, state: AdamState):
        mu = (1.0 - self.b1) * g + self.b1 * state.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * state.nu
        count = state.count + 1
        t = count.to(g.dtype)
        mu_hat = mu / (1.0 - self.b1 ** t)
        nu_hat = nu / (1.0 - self.b2 ** t)
        upd = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
        return -self.lr * upd, AdamState(count=count, mu=mu, nu=nu)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class SVGD:
    """First-order SVGD sampler; ``optimizer`` is an :class:`Adam` or None
    for the raw ``lr`` update. ``kernel`` is the analytic kernel used when
    the score carries no kernel terms; ``fused_velocity`` sends a plain
    :class:`GaussianKernel` velocity through K9 (not with a
    ``repulsion_schedule``, which scales the kernel gradient apart).
    ``adagrad=True`` takes the hand-rolled Adagrad in the raw update; a
    particle-shaped {0, 1} ``gradient_mask`` multiplies φ."""

    kernel: Any = dataclasses.field(default_factory=GaussianKernel)
    optimizer: Optional[Adam] = None
    lr: float = 1e-2
    adagrad: bool = False
    log_prior: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    repulsion_schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    gradient_mask: Optional[torch.Tensor] = None
    fused_velocity: bool = False

    def init(self, particles: torch.Tensor) -> SVGDState:
        if self.optimizer is not None:
            opt_state = self.optimizer.init(particles)
        elif self.adagrad:
            opt_state = torch.zeros_like(particles)
        else:
            opt_state = ()
        return SVGDState(
            opt_state=opt_state,
            step=torch.zeros((), dtype=torch.int32, device=particles.device),
        )

    def _kernel_terms(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.kernel(_flat(x), _flat(x))

    def velocity(self, x: torch.Tensor, score: ScoreResult, step
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stein velocity φ (particle-shaped) and the logged loss."""
        n = x.shape[0]
        s = _flat(score.grad_log_p)
        if self.log_prior is not None:
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                (prior_grad,) = torch.autograd.grad(self.log_prior(xx).sum(), xx)
            s = s + _flat(prior_grad)
        use_fused = (self.fused_velocity and score.k_xx is None
                     and self.repulsion_schedule is None
                     and type(self.kernel) is GaussianKernel)
        if use_fused:
            xf = _flat(x)
            h = self.kernel.bandwidth(pw_dist_sq(xf, xf))  # outside the kernel
            phi = fused_rbf_velocity(xf, s, h).reshape(x.shape)
        else:
            if score.k_xx is not None and score.grad_k is not None:
                k_xx, grad_k = score.k_xx, _flat(score.grad_k)
            else:
                k_xx, grad_k = self._kernel_terms(x)
            if self.repulsion_schedule is not None:
                grad_k = grad_k * self.repulsion_schedule(step)
            phi = ((k_xx @ s - grad_k) / n).reshape(x.shape)
        if self.gradient_mask is not None:
            phi = phi * self.gradient_mask
        loss = score.loss if score.loss is not None else torch.linalg.norm(s)
        return phi, loss

    def apply_update(self, x: torch.Tensor, grad: torch.Tensor, opt_state):
        """``grad`` is the descent direction (``-φ``)."""
        if self.optimizer is not None:
            updates, opt_state = self.optimizer.update(grad, opt_state)
            return x + updates, opt_state
        if self.adagrad:
            inertia = opt_state + grad ** 2
            return x - self.lr * grad / torch.sqrt(inertia + 1e-12), inertia
        return x - self.lr * grad, opt_state

    def step_update(self, x: torch.Tensor, state: SVGDState,
                    score: ScoreResult) -> Tuple[torch.Tensor, SVGDState]:
        phi, _loss = self.velocity(x, score, state.step)
        x, opt_state = self.apply_update(x, -phi, state.opt_state)
        return x, SVGDState(opt_state=opt_state, step=state.step + 1)

    def run(self, particles: torch.Tensor, score_fn: ScoreFn, n_steps: int,
            generator: Optional[torch.Generator] = None,
            state: Optional[SVGDState] = None, value_fn=None
            ) -> Tuple[torch.Tensor, SVGDState, RunData]:
        """``n_steps`` SVGD steps; ``score_fn(x, generator)`` scores each.
        ``state`` threads the optimizer state across calls. Returns the final
        particles, the state, and the trace (initial particles, then each
        step's), the per-step losses and the stacked score aux. A
        ``value_fn`` (for line-search optimizers) raises: LBFGS is ROADMAP
        M10."""
        if value_fn is not None:
            raise NotImplementedError(
                "value_fn feeds the LBFGS line search, not ported yet "
                "(ROADMAP.md queue 1, M10)")
        if state is None:
            state = self.init(particles)
        x = particles
        trace, losses, auxes = [particles], [], []
        for _ in range(n_steps):
            score = score_fn(x, generator)
            phi, loss = self.velocity(x, score, state.step)
            x, opt_state = self.apply_update(x, -phi, state.opt_state)
            state = SVGDState(opt_state=opt_state, step=state.step + 1)
            trace.append(x)
            losses.append(loss)
            auxes.append(score.aux)
        return x, state, RunData(trace=torch.stack(trace),
                                 loss=torch.stack(losses) if losses else
                                 torch.zeros(0, device=particles.device),
                                 aux=_stack_aux(auxes))

    def run_host_loop(self, particles: torch.Tensor, score_fn: ScoreFn,
                      n_steps: int, generator: Optional[torch.Generator] = None,
                      state: Optional[SVGDState] = None, trace_every: int = 0,
                      value_fn=None) -> Tuple[torch.Tensor, SVGDState, RunData]:
        """:meth:`run`'s steps, with the JAX package's host-loop logging:
        the trace holds the initial particles, every ``trace_every``-th
        step's and always the final ones (with ``trace_every=0`` only the
        first and the last); the loss is the score's, zero without one; no
        aux. A ``value_fn`` raises, as in :meth:`run`."""
        if value_fn is not None:
            raise NotImplementedError(
                "value_fn feeds the LBFGS line search, not ported yet "
                "(ROADMAP.md queue 1, M10)")
        if state is None:
            state = self.init(particles)
        x = particles
        trace = [particles] if trace_every else []
        losses = []
        for i in range(n_steps):
            score = score_fn(x, generator)
            x, state = self.step_update(x, state, score)
            losses.append(score.loss if score.loss is not None
                          else torch.zeros((), device=particles.device))
            if trace_every and (i + 1) % trace_every == 0:
                trace.append(x)
        if not trace_every:
            trace = [particles, x]
        elif n_steps % trace_every:
            trace.append(x)
        return x, state, RunData(trace=torch.stack(trace),
                                 loss=torch.stack(losses) if losses else
                                 torch.zeros(0, device=particles.device),
                                 aux=None)


def roll_opt_state(opt_state, particle_shape: Tuple[int, ...]):
    """Shift optimizer state with the receding horizon: every leaf whose
    trailing dims are ``particle_shape`` (Adam's moments, the Adagrad
    accumulator) rolls one step along the horizon axis (-2), its last step
    zero-filled; other leaves (step counts) pass through."""
    nd = len(particle_shape)

    def roll_leaf(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= nd
                and tuple(leaf.shape[-nd:]) == tuple(particle_shape)):
            rolled = torch.roll(leaf, -1, dims=-2)
            rolled[..., -1, :] = 0.0
            return rolled
        return leaf

    def tree_map(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(tree_map(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(tree_map(c) for c in node)
        if isinstance(node, dict):
            return {k: tree_map(v) for k, v in node.items()}
        return roll_leaf(node)

    return tree_map(opt_state)


def _stack_aux(auxes):
    """Stack the per-step aux dicts over the steps (None without aux)."""
    if not auxes or auxes[0] is None:
        return None
    return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


@dataclasses.dataclass(frozen=True)
class ScaledSVGD(SVGD):
    """Second-order SVGD with the Gauss-Newton metric ``M = 2·mean_i(s_i
    s_iᵀ) + eps·I``, ``eps`` the unbiased variance of the flattened
    particles, built from the likelihood score before the prior gradient
    joins it and handed to the kernel as ``M=``; ``precondition=True``
    solves ``M φᵀ`` ("MatrixSVGD"). As in the JAX package, the velocity
    always takes its own kernel on the flattened particles: a score's
    ``k_xx``/``grad_k`` (trajectory or signature mode) are not read, and
    ``fused_velocity`` does not apply."""

    metric: str = "GaussNewton"
    precondition: bool = True

    def velocity(self, x: torch.Tensor, score: ScoreResult, step
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.metric.lower() != "gaussnewton":
            raise NotImplementedError(
                f"metric {self.metric!r} is not implemented; GaussNewton is the "
                "only one, as in the JAX package")
        n = x.shape[0]
        s = _flat(score.grad_log_p)
        eps = torch.var(_flat(x), correction=1)
        m = 2.0 * torch.mean(s[:, :, None] * s[:, None, :], dim=0)
        m = m + eps * torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        if self.log_prior is not None:
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                (prior_grad,) = torch.autograd.grad(self.log_prior(xx).sum(), xx)
            s = s + _flat(prior_grad)
        k_xx, grad_k = self.kernel(_flat(x), _flat(x), M=m)
        if self.repulsion_schedule is not None:
            grad_k = grad_k * self.repulsion_schedule(step)
        phi = (k_xx @ s - grad_k) / n
        if self.precondition:
            phi = torch.linalg.solve(m, phi.T).T
        phi = phi.reshape(x.shape)
        if self.gradient_mask is not None:
            phi = phi * self.gradient_mask
        loss = score.loss if score.loss is not None else torch.linalg.norm(s)
        return phi, loss


def matrix_svgd(kernel=None, **kwargs) -> ScaledSVGD:
    """"MatrixSVGD": :class:`ScaledSVGD` preconditioned by its metric, with a
    :class:`ScaledGaussianKernel` unless a kernel is given."""
    return ScaledSVGD(kernel=kernel or ScaledGaussianKernel(), precondition=True,
                      **kwargs)
