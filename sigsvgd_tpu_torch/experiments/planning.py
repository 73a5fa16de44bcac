"""Open-loop arm trajectory optimisation: spline knots as Stein particles
(port of ``sigsvgd_tpu/experiments/planning.py``).

The free knot configurations ``x [batch, n_knots, dof]`` are the SVGD
particles. Each expands through a natural cubic spline into a T-step joint
trajectory; FK maps it to link positions; the cost combines the occupancy of
points along the arm, an optional self-collision term, the weighted joint
and end-effector path length, and the end-effector curvature. The Stein
repulsion is the signature kernel on the knot paths (``pathsig``) or an RBF
kernel on the flattened knots (``svgd``/``svgd_med``).

Ported as the JAX package has it, quirks included: the curvature term is the
mean over the whole batch, the same for every particle. Two options still
raise: LBFGS (``optimizer="lbfgs"``, ROADMAP.md queue 1, item 10) and
checkpointed runs (``checkpoint_dir``, item 14's ``utils/checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..inference.score import pathsig_score, sgd_score, svgd_score
from ..inference.svgd import SVGD
from ..kernels.rbf import GaussianKernel
from ..kernels.sigkernel import SignatureKernel
from ..models.robot.panda import PandaRobot
from ..models.robot.scene import Scene, scene_sdf
from ..utils import schedulers
from ..utils.math import safe_norm, smoothed_box_log_prob
from ..utils.splines import (
    natural_cubic_spline_coeffs,
    spline_derivative,
    spline_trajectory,
)


def create_body_points(xs: torch.Tensor, n_pts: int = 10) -> torch.Tensor:
    """Interpolate points along each arm segment:
    ``[..., L, 3] → [..., (L-1)*n_pts, 3]``."""
    frac = torch.linspace(0.0, 1.0, n_pts + 1, dtype=xs.dtype,
                          device=xs.device)[:-1]
    seg0 = xs[..., :-1, None, :]
    seg1 = xs[..., 1:, None, :]
    pts = seg0 + frac[:, None] * (seg1 - seg0)
    return pts.reshape(xs.shape[:-2] + (-1, 3))


def sdf_occupancy(scene: Scene, sharpness: float = 50.0):
    """Exact-SDF soft occupancy ``sigmoid(-sharpness·sdf)``."""

    def occ(x):
        return torch.sigmoid(-sharpness * scene_sdf(scene, x))

    return occ


def _full_knots(problem: "PlanningProblem", x: torch.Tensor) -> torch.Tensor:
    """The free knots between the start and target configurations."""
    batch, dof = x.shape[0], x.shape[-1]
    return torch.cat([problem.q_start.expand(batch, 1, dof), x,
                      problem.q_target.expand(batch, 1, dof)], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class PlanningProblem:
    """Static description of one planning instance."""

    robot: PandaRobot
    q_start: torch.Tensor  # [dof]
    q_target: torch.Tensor  # [dof]
    occupancy_fn: Callable[[torch.Tensor], torch.Tensor]  # [..., 3] -> [...]
    self_collision_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    timesteps: int = 200
    n_body_points: int = 10
    w_collision: float = 1.0
    w_self_collision: float = 10.0
    w_trajdist: float = 2.5
    w_curvature: float = 1.0

    def batch_cost(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Cost of knot particles ``x [batch, n_knots, dof]`` → ``[batch]``
        and its parts."""
        batch = x.shape[0]
        qs = spline_trajectory(_full_knots(self, x), self.timesteps)  # [b, T, dof]
        xs = self.robot.qs_to_joints_xs(qs)  # [batch, T, L, 3]
        ee_xs = xs[..., -1, :]

        q_weights = torch.linspace(1.0, 0.7, qs.shape[-1], dtype=x.dtype,
                                   device=x.device)
        qs_dist = safe_norm(q_weights * (qs[:, 1:] - qs[:, :-1])).sum(-1)
        ee_dist = safe_norm(ee_xs[:, 1:] - ee_xs[:, :-1]).sum(-1)
        traj_dist = qs_dist + ee_dist

        body = create_body_points(xs, self.n_body_points)  # [batch, T, P, 3]
        col_prob = self.occupancy_fn(body).mean(-1).sum(-1)

        if self.self_collision_fn is not None:
            self_col = self.self_collision_fn(qs).sum(-1)
        else:
            self_col = torch.zeros((batch,), dtype=x.dtype, device=x.device)

        t_knots = torch.linspace(0.0, 1.0, self.timesteps, dtype=x.dtype,
                                 device=x.device)
        spline = natural_cubic_spline_coeffs(t_knots, ee_xs)
        tq = torch.linspace(0.0, 1.0, 50, dtype=x.dtype, device=x.device)
        d1 = spline_derivative(spline, tq, 1)
        d2 = spline_derivative(spline, tq, 2)
        cross = torch.linalg.cross(d1, d2, dim=-1)
        curvature = safe_norm(cross) / (safe_norm(d1) ** 3 + 1e-6)
        curvature = curvature.mean()  # over the whole batch, as the reference

        cost = (self.w_collision * col_prob + self.w_self_collision * self_col
                + self.w_trajdist * traj_dist + self.w_curvature * curvature)
        aux = {
            "costs_col": self.w_collision * col_prob,
            "costs_self_col": self.w_self_collision * self_col,
            "costs_dist": traj_dist,
            "costs_curvature": (self.w_curvature * curvature).expand(cost.shape),
        }
        return cost, aux


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Hyperparameters; the defaults are the reference's flagship run (20
    particles, 500 iterations, 5 knots, signature kernel at dyadic order 6).
    ``mxu_precision="default"`` sends the order-6 Gram through the hop
    chain K8 (bf16 products, fp32 accumulation); "highest" runs it in fp32."""

    method: str = "pathsig"  # pathsig | svgd | svgd_med | sgd | ps_sgd
    n_iter: int = 500
    batch: int = 20
    length: int = 5  # total knots incl. endpoints
    lr: float = 1e-3
    optimizer: str = "raw"  # raw (lr update) | lbfgs (not ported: M10)
    pathsig_bw: float = 1.5
    svgd_bw: float = 1.5
    depth: int = 6  # dyadic order of the PDE signature kernel
    timesteps: int = 200
    mxu_precision: str = "default"


def planner_sampler(problem: PlanningProblem, config: PlannerConfig):
    """``(SVGD sampler, score function)`` of a planning run: the raw-lr
    update with the joint-limit box prior and the cosine repulsion schedule
    (``ρ`` 1 → 0 from a quarter to three quarters of ``n_iter``)."""
    if config.optimizer != "raw":
        raise NotImplementedError(
            f"optimizer={config.optimizer!r}: LBFGS with the zoom line search is "
            "not ported yet (ROADMAP.md queue 1, item 10: M10's LBFGS)")
    lower, upper = problem.robot.joint_limits()
    schedule = schedulers.cosine(1.0, 0.0, 3 * config.n_iter // 4, config.n_iter // 4)

    def log_prior(x):
        return smoothed_box_log_prob(x, lower, upper, 0.1).sum(-1)

    if config.method == "svgd":
        # the reference's fixed bandwidth, under which K ≈ I on these knots
        score = svgd_score(problem.batch_cost,
                           GaussianKernel(bandwidth_fn=lambda _: config.svgd_bw))
    elif config.method == "svgd_med":
        score = svgd_score(problem.batch_cost, GaussianKernel())
    elif config.method == "sgd":
        score = sgd_score(problem.batch_cost)
    elif config.method in ("pathsig", "ps_sgd"):
        kernel = SignatureKernel(dyadic_order=config.depth,
                                 bandwidth=config.pathsig_bw,
                                 mxu_precision=config.mxu_precision)
        score = pathsig_score(problem.batch_cost, kernel)
    else:
        raise ValueError(f"unknown method {config.method!r}")
    svgd = SVGD(lr=config.lr, log_prior=log_prior, repulsion_schedule=schedule)
    return svgd, score


def uniform_knots(robot, n: int, n_free: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Knot particles ``[n, n_free, dof]`` uniform within the robot's joint
    limits, drawn with ``generator`` on the robot's device."""
    lower, upper = robot.joint_limits()
    u = torch.rand((n, n_free, robot.dof), generator=generator, device=lower.device)
    return lower + (upper - lower) * u


def run_optimisation(problem: PlanningProblem, config: PlannerConfig,
                     generator: Optional[torch.Generator] = None,
                     x0: Optional[torch.Tensor] = None,
                     checkpoint_dir: Optional[str] = None):
    """SVGD trajectory optimisation on the problem's device. ``x0`` defaults
    to knots uniform within the joint limits, drawn with ``generator``.
    Returns ``(final knots, RunData)``, or ``(final knots, (warm-up RunData,
    SGD RunData))`` for ``ps_sgd``."""
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointed planning runs are not ported yet (ROADMAP.md queue 1, "
            "item 14: M14's utils/checkpoint.py)")
    svgd, score = planner_sampler(problem, config)
    if x0 is None:
        x0 = uniform_knots(problem.robot, config.batch, config.length - 2, generator)
    if config.method == "ps_sgd":
        # signature-kernel warm-up, then plain SGD refinement
        n_warm = config.n_iter - config.n_iter // 4
        x_mid, state, data1 = svgd.run(x0, score, n_warm, generator=generator)
        x_final, _, data2 = svgd.run(x_mid, sgd_score(problem.batch_cost),
                                     config.n_iter // 4, generator=generator,
                                     state=state)
        return x_final, (data1, data2)
    x_final, _, data = svgd.run(x0, score, config.n_iter, generator=generator)
    return x_final, data


def evaluate_trajectory(problem: PlanningProblem, x: torch.Tensor,
                        threshold: float = 0.2) -> Dict[str, torch.Tensor]:
    """Per-particle success metrics: max occupancy, max self-collision, EE
    path length; success when both maxima are at most ``threshold``."""
    batch = x.shape[0]
    qs = spline_trajectory(_full_knots(problem, x), problem.timesteps)
    xs = problem.robot.qs_to_joints_xs(qs)
    body = create_body_points(xs, problem.n_body_points)
    max_occ = torch.amax(problem.occupancy_fn(body), dim=(-1, -2))
    if problem.self_collision_fn is not None:
        max_self = torch.amax(problem.self_collision_fn(qs), dim=-1)
    else:
        max_self = torch.zeros((batch,), dtype=x.dtype, device=x.device)
    ee = xs[..., -1, :]
    ee_len = torch.linalg.norm(ee[:, 1:] - ee[:, :-1], dim=-1).sum(-1)
    success = (max_occ <= threshold) & (max_self <= threshold)
    return {"max_occ": max_occ, "max_self_collision": max_self,
            "ee_path_length": ee_len, "success": success}
