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
hand-rolled Adagrad, the raw ``lr`` step, or L-BFGS with the zoom
line search (:func:`lbfgs`, optax's as the JAX package builds it), which
probes a scalar ``value_fn`` of the particles along its direction and takes
the Stein velocity −φ as the gradient at the current particles. A
``value_fn`` under any other update is ignored, as in the JAX package.
:func:`roll_opt_state` shifts the optimizer state with a receding horizon.
:meth:`SVGD.run` and :meth:`SVGD.run_host_loop` are the same Python loop
over the steps (PyTorch runs eagerly); they differ in what they log, as in
the JAX package. :class:`ScaledSVGD` is the second-order sampler with a
Gauss-Newton metric (:func:`matrix_svgd` preconditions by it).
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
    opt_state: Any  # AdamState, LBFGSState, the Adagrad sum, or () for the raw lr
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


class ScaleByLBFGSState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor  # [m, *params.shape], a ring at count % m
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor  # [m]


class EmptyState(NamedTuple):
    """The state of the ``scale(-1)`` link: no leaves."""


class ZoomLinesearchInfo(NamedTuple):
    num_linesearch_steps: torch.Tensor  # int32 scalar
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor


class ScaleByZoomLinesearchState(NamedTuple):
    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    info: ZoomLinesearchInfo


LBFGSState = Tuple[ScaleByLBFGSState, EmptyState, ScaleByZoomLinesearchState]


class _Zoom(NamedTuple):
    """The zoom line search's running state (optax's
    ``ZoomLinesearchState`` without its fixed params, direction and guess)."""

    count: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _where(cond, a: tuple, b: tuple) -> tuple:
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through ``(a, fa)``, ``(b, fb)``,
    ``(c, fc)`` with slope ``fpa`` at ``a`` (NaN when there is none), in
    optax's order of operations."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through ``(a, fa)``, ``(b, fb)`` with
    slope ``fpa`` at ``a``."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


# optax 0.2.6's zoom_linesearch defaults, the only values the JAX package uses
_LS_TOL = 0.0
_LS_INCREASE_FACTOR = 2.0
_LS_SLOPE_RTOL = 1e-4
_LS_CURV_RTOL = 0.9
_LS_APPROX_DEC_RTOL = 1e-6
_LS_STEPSIZE_PRECISION = 1e-5


def _value_and_grad(value_fn, x: torch.Tensor):
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        v = value_fn(xx)
        (g,) = torch.autograd.grad(v, xx)
    return v.detach(), g


@dataclasses.dataclass(frozen=True)
class LBFGS:
    """optax 0.2.6's ``lbfgs(memory_size, linesearch=
    scale_by_zoom_linesearch(max_linesearch_steps))``: the two-loop recursion
    over a ring of ``memory_size`` curvature pairs (γ₀ the gradient norm's
    reciprocal capped at 1), then the zoom line search (Nocedal and Wright's
    Algorithms 3.5 and 3.6 with Hager and Zhang's approximate decrease test)
    from the last step size. Its state is optax's, leaf for leaf.

    Each probe of the search evaluates ``value_fn`` and its gradient
    (autograd) once. Both of the search's phases are computed from that
    probe on the device and the one the state is in is selected, so the host
    reads one stop flag a probe."""

    memory_size: int = 10
    max_linesearch_steps: int = 15

    def init(self, params: torch.Tensor) -> LBFGSState:
        def scalar(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=params.device)

        mem = torch.zeros((self.memory_size,) + tuple(params.shape), dtype=params.dtype,
                          device=params.device)
        return (
            ScaleByLBFGSState(count=scalar(0, torch.int32), params=torch.zeros_like(params),
                              updates=torch.zeros_like(params), diff_params_memory=mem,
                              diff_updates_memory=mem.clone(),
                              weights_memory=torch.zeros(self.memory_size,
                                                         device=params.device)),
            EmptyState(),
            ScaleByZoomLinesearchState(
                learning_rate=scalar(1.0), value=scalar(float("inf")),
                grad=torch.zeros_like(params),
                info=ZoomLinesearchInfo(num_linesearch_steps=scalar(0, torch.int32),
                                        decrease_error=scalar(float("inf")),
                                        curvature_error=scalar(float("inf")))),
        )

    # -- scale_by_lbfgs ----------------------------------------------------
    def _direction(self, grad: torch.Tensor, lb: ScaleByLBFGSState, params: torch.Tensor):
        m = self.memory_size
        count = lb.count
        started = count > 0
        memory_idx = torch.remainder(count, m)
        prev_idx = torch.remainder(count - 1, m).reshape(1).long()

        diff_params = params - lb.params
        diff_updates = grad - lb.updates
        vd = _vdot(diff_updates, diff_params)
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        diff_params = torch.where(started, diff_params, torch.zeros_like(diff_params))
        diff_updates = torch.where(started, diff_updates, torch.zeros_like(diff_updates))
        weight = torch.where(started, weight, torch.zeros_like(weight))
        dpm = lb.diff_params_memory.index_copy(0, prev_idx, diff_params[None])
        dum = lb.diff_updates_memory.index_copy(0, prev_idx, diff_updates[None])
        wm = lb.weights_memory.index_copy(0, prev_idx, weight[None])

        numerator = _vdot(diff_updates, diff_params)
        denominator = (diff_updates * diff_updates).sum()
        identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                     torch.ones_like(numerator))
        inv_norm = 1.0 / torch.sqrt((grad * grad).sum())
        capped_inv_norm = torch.minimum(torch.ones_like(inv_norm), inv_norm)
        identity_scale = torch.where(started, identity_scale, capped_inv_norm)

        # the two loops over the ring from the oldest pair (memory_idx) on
        order = torch.remainder(memory_idx + torch.arange(m, device=grad.device), m)
        dw, du, rho = dpm[order], dum[order], wm[order]
        vec, alphas = grad, [None] * m
        for k in reversed(range(m)):
            alphas[k] = rho[k] * _vdot(dw[k], vec)
            vec = vec + (-alphas[k]) * du[k]
        vec = identity_scale * vec
        for k in range(m):
            beta = rho[k] * _vdot(du[k], vec)
            vec = vec + (alphas[k] - beta) * dw[k]
        new = ScaleByLBFGSState(count=count + 1, params=params, updates=grad,
                                diff_params_memory=dpm, diff_updates_memory=dum,
                                weights_memory=wm)
        return -1.0 * vec, new

    # -- zoom_linesearch ---------------------------------------------------
    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        dec = value_step - value_init - _LS_SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * _LS_SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init - _LS_APPROX_DEC_RTOL * torch.abs(value_init)
        approx = torch.maximum(approx, delta_values)
        dec = torch.minimum(approx, dec)
        dec = torch.clamp_min(dec, 0.0)
        return torch.where(torch.isnan(dec), torch.full_like(dec, float("inf")), dec)

    def _curvature_error(self, slope_step, slope_init):
        curv = torch.abs(slope_step) - _LS_CURV_RTOL * torch.abs(slope_init)
        curv = torch.clamp_min(curv, 0.0)
        return torch.where(torch.isnan(curv), torch.full_like(curv, float("inf")), curv)

    def _zoom_middle(self, s: _Zoom) -> torch.Tensor:
        """The zoom phase's next step size: the cubic's minimum, else the
        quadratic's, else the bisection, each only well inside the interval."""
        delta = torch.abs(s.high - s.low)
        left = torch.minimum(s.high, s.low)
        right = torch.maximum(s.high, s.low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        mc = _cubicmin(s.low, s.value_low, s.slope_low, s.high, s.value_high, s.cubic_ref,
                       s.value_cubic_ref)
        use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
        mq = _quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
        use_quad = ~use_cubic & (mq > left + quad_chk) & (mq < right - quad_chk)
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, mc, s.cubic_ref)
        middle = torch.where(use_quad, mq, middle)
        return torch.where(use_bisection, (s.low + s.high) / 2.0, middle)

    def _search(self, s: _Zoom, t, value, grad, slope, value_init, slope_init) -> _Zoom:
        """Algorithm 3.5 (the interval search) after a probe at ``t``."""
        tol, steps = _LS_TOL, self.max_linesearch_steps
        dec = self._decrease_error(t, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        error = torch.maximum(dec, curv)
        safe = _where(dec <= tol, (t, value, grad), (s.safe_stepsize, s.safe_value, s.safe_grad))
        set_high = (dec > 0.0) | ((value >= s.value) & (s.count > 0))
        set_low = (slope >= 0.0) & ~set_high
        low, value_low, slope_low, high, value_high, slope_high = _where(
            set_low, (t, value, slope, s.stepsize, s.value, s.slope),
            (s.stepsize, s.value, s.slope, t, value, slope))
        done = error <= tol
        return _Zoom(
            count=s.count + 1, stepsize=t, value=value, grad=grad, slope=slope,
            decrease_error=dec, curvature_error=curv,
            interval_found=set_high | set_low | done, done=done,
            failed=(s.count + 1 >= steps) & ~done,
            low=low, value_low=value_low, slope_low=slope_low, high=high,
            value_high=value_high, slope_high=slope_high, cubic_ref=low,
            value_cubic_ref=value_low, safe_stepsize=safe[0], safe_value=safe[1],
            safe_grad=safe[2])

    def _zoom(self, s: _Zoom, t, value, grad, slope, value_init, slope_init) -> _Zoom:
        """Algorithm 3.6 (the zoom) after a probe at ``t``."""
        tol, steps = _LS_TOL, self.max_linesearch_steps
        too_small_int = torch.abs(s.high - s.low) <= _LS_STEPSIZE_PRECISION
        dec = self._decrease_error(t, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        error = torch.maximum(dec, curv)
        safe = _where((dec <= tol) & (value < s.safe_value), (t, value, grad),
                      (s.safe_stepsize, s.safe_value, s.safe_grad))
        done = error <= tol
        set_high_to_middle = (dec > 0.0) | (value >= s.value_low)
        set_high_to_low = (slope * (s.high - s.low) >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle
        high = _where(set_high_to_middle, (t, value, slope),
                      (s.high, s.value_high, s.slope_high))
        high = _where(set_high_to_low, (s.low, s.value_low, s.slope_low), high)
        low = _where(set_low_to_middle, (t, value, slope), (s.low, s.value_low, s.slope_low))
        cubic = _where(set_high_to_middle | set_high_to_low, (s.high, s.value_high),
                       (s.low, s.value_low))
        presumably_failed = (s.count + 1 >= steps) | (too_small_int & (safe[0] > 0.0))
        return _Zoom(
            count=s.count + 1, stepsize=t, value=value, grad=grad, slope=slope,
            decrease_error=dec, curvature_error=curv, interval_found=s.interval_found,
            done=done, failed=presumably_failed & ~done,
            low=low[0], value_low=low[1], slope_low=low[2], high=high[0],
            value_high=high[1], slope_high=high[2], cubic_ref=cubic[0],
            value_cubic_ref=cubic[1], safe_stepsize=safe[0], safe_value=safe[1],
            safe_grad=safe[2])

    def _linesearch(self, updates, params, value, grad, stepsize_guess, value_fn) -> _Zoom:
        slope = _vdot(updates, grad)
        zero = torch.zeros((), dtype=torch.float32, device=params.device)
        inf = torch.full_like(zero, float("inf"))
        false = torch.zeros((), dtype=torch.bool, device=params.device)
        s = _Zoom(count=torch.zeros((), dtype=torch.int32, device=params.device),
                  stepsize=zero, value=value, grad=grad, slope=slope, decrease_error=inf,
                  curvature_error=inf, interval_found=false, done=false, failed=false,
                  low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
                  slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
                  safe_stepsize=zero, safe_value=value, safe_grad=grad)
        while True:
            search_t = torch.where(s.count == 0, stepsize_guess,
                                   _LS_INCREASE_FACTOR * s.stepsize)
            t = torch.where(s.interval_found, self._zoom_middle(s), search_t)
            v, g = _value_and_grad(value_fn, params + t * updates)
            sl = _vdot(g, updates)
            probe = (t, v, g, sl, value, slope)
            s = _Zoom(*_where(s.interval_found, self._zoom(s, *probe), self._search(s, *probe)))
            # a failed search falls back to the best point of sufficient decrease
            fallback = (s.safe_stepsize > 0.0) | torch.isinf(s.decrease_error)
            take = s.failed & fallback
            stepsize, value_f, grad_f = _where(take, (s.safe_stepsize, s.safe_value,
                                                      s.safe_grad), (s.stepsize, s.value, s.grad))
            s = s._replace(stepsize=stepsize, value=value_f, grad=grad_f)
            if bool(s.done | s.failed):  # the one host read of a probe
                return s

    def update(self, grad: torch.Tensor, state: LBFGSState, params: torch.Tensor,
               value: torch.Tensor, value_fn: Callable[[torch.Tensor], torch.Tensor]):
        """``(updates, state)``: ``params + updates`` is the next iterate.
        ``grad`` is both the direction's input and the gradient the search
        takes at ``params``; ``value`` is ``value_fn(params)``."""
        lb, empty, ls = state
        direction, lb = self._direction(grad, lb, params)
        s = self._linesearch(direction, params, value, grad, ls.learning_rate, value_fn)
        ls = ScaleByZoomLinesearchState(
            learning_rate=s.stepsize, value=s.value, grad=s.grad,
            info=ZoomLinesearchInfo(num_linesearch_steps=s.count,
                                    decrease_error=s.decrease_error,
                                    curvature_error=s.curvature_error))
        return s.stepsize * direction, (lb, empty, ls)


def lbfgs(memory_size: int = 10, max_linesearch_steps: int = 15) -> LBFGS:
    """L-BFGS with the zoom line search, as the JAX package's ``lbfgs``."""
    return LBFGS(memory_size=memory_size, max_linesearch_steps=max_linesearch_steps)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class SVGD:
    """First-order SVGD sampler; ``optimizer`` is an :class:`Adam`, an
    :class:`LBFGS` or None for the raw ``lr`` update. ``kernel`` is the analytic kernel used when
    the score carries no kernel terms; ``fused_velocity`` sends a plain
    :class:`GaussianKernel` velocity through K9 (not with a
    ``repulsion_schedule``, which scales the kernel gradient apart).
    ``adagrad=True`` takes the hand-rolled Adagrad in the raw update; a
    particle-shaped {0, 1} ``gradient_mask`` multiplies φ."""

    kernel: Any = dataclasses.field(default_factory=GaussianKernel)
    optimizer: Optional[Any] = None  # Adam | LBFGS
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

    def apply_update(self, x: torch.Tensor, grad: torch.Tensor, opt_state,
                     value=None, value_fn=None):
        """``grad`` is the descent direction (``-φ``). Under :class:`LBFGS`
        the line search probes ``value_fn`` (``value`` is ``value_fn(x)``,
        computed when not given) and takes ``grad`` as the gradient at
        ``x``, though the Stein velocity is no gradient field; any other
        update ignores ``value_fn``."""
        if isinstance(self.optimizer, LBFGS):
            if value_fn is None:
                raise ValueError("the LBFGS line search needs a value_fn")
            if value is None:
                with torch.no_grad():
                    value = value_fn(x)
            updates, opt_state = self.optimizer.update(grad, opt_state, x, value=value,
                                                       value_fn=value_fn)
            return x + updates, opt_state
        if self.optimizer is not None:
            updates, opt_state = self.optimizer.update(grad, opt_state)
            return x + updates, opt_state
        if self.adagrad:
            inertia = opt_state + grad ** 2
            return x - self.lr * grad / torch.sqrt(inertia + 1e-12), inertia
        return x - self.lr * grad, opt_state

    def step_update(self, x: torch.Tensor, state: SVGDState, score: ScoreResult,
                    value_fn=None) -> Tuple[torch.Tensor, SVGDState]:
        phi, _loss = self.velocity(x, score, state.step)
        x, opt_state = self.apply_update(x, -phi, state.opt_state, value_fn=value_fn)
        return x, SVGDState(opt_state=opt_state, step=state.step + 1)

    def run(self, particles: torch.Tensor, score_fn: ScoreFn, n_steps: int,
            generator: Optional[torch.Generator] = None,
            state: Optional[SVGDState] = None, value_fn=None
            ) -> Tuple[torch.Tensor, SVGDState, RunData]:
        """``n_steps`` SVGD steps; ``score_fn(x, generator)`` scores each.
        ``state`` threads the optimizer state across calls. Returns the final
        particles, the state, and the trace (initial particles, then each
        step's), the per-step losses and the stacked score aux. ``value_fn``
        feeds the LBFGS line search (ignored by the other updates)."""
        if state is None:
            state = self.init(particles)
        x = particles
        trace, losses, auxes = [particles], [], []
        for _ in range(n_steps):
            score = score_fn(x, generator)
            phi, loss = self.velocity(x, score, state.step)
            x, opt_state = self.apply_update(x, -phi, state.opt_state, value_fn=value_fn)
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
        aux. ``value_fn`` as in :meth:`run`."""
        if state is None:
            state = self.init(particles)
        x = particles
        trace = [particles] if trace_every else []
        losses = []
        for i in range(n_steps):
            score = score_fn(x, generator)
            x, state = self.step_update(x, state, score, value_fn=value_fn)
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
    accumulator, LBFGS's params, updates and ``[m, ...]`` memories and its
    line search's gradient) rolls one step along the horizon axis (-2), its last step
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
