"""The flagship MPC problem: DuSt on the 7-DoF Panda.

The problem ``bench.py`` measures (``_setup``): a joint-velocity integrator
clipped to the Panda's limits, horizon 40, 1024 policy particles, Adam(0.1),
costs from batched FK of 9 links, 4 body points per segment, exact-SDF
occupancy of ``bookshelf_small`` and end-effector tracking. Its three
controllers: the Stein repulsion of ``SignatureKernel(dyadic_order=3,
bandwidth=4.0)`` after ``calibrate_dyadic_order`` on a warm-up rollout
(``ctrl_sig``), the same kernel pinned at order 3 (``ctrl_sig_pinned``,
``calibrate=False``), and the RBF kernel on the policies (``ctrl_rbf``,
``kernel_mode="policy"``). ``chip_smoke.py`` and the tests build them here,
the pinned controller with the linear static kernel (``static="linear"``:
the λ=3 pair list through K5), the JAX ``DuSt``'s default signature kernel
(order 2, the wavefront), the trajectory kernel mode and the ScaledSVGD and
MatrixSVGD samplers.

:func:`build_planning_problem` gives bench's second workload on the same
arm and scene (``bench_planning_iter``): open-loop trajectory optimisation
from the same start to the same target configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..controllers.dust import DuSt
from ..inference.svgd import Adam
from ..kernels.rbf import GaussianKernel
from ..kernels.sigkernel import SignatureKernel
from ..models.base import DynamicsModel, ParamsDict
from ..models.robot.panda import PandaRobot
from ..models.robot.scene import get_scene
from ..utils.math import clip
from ..utils.spaces import Box
from .planning import PlanningProblem, create_body_points, sdf_occupancy

DOF = 7
Q_START = (0.0, 0.0, 0.0, -1.5, 0.0, 1.5, 0.0)
Q_TARGET = (1.2, 0.6, -0.4, -1.2, 0.3, 1.8, 0.5)
CALIBRATION_TOL = 1e-3


@dataclasses.dataclass(frozen=True, eq=False)
class ArmModel(DynamicsModel):
    """7-DoF joint-velocity integrator clipped to the Panda's limits."""

    low: torch.Tensor = None
    high: torch.Tensor = None

    @property
    def observation_space(self) -> Box:
        return Box.create(DOF, low=self.low, high=self.high)

    @property
    def action_space(self) -> Box:
        return Box.create(DOF, low=-2.0, high=2.0)

    def step(self, states, actions, params: ParamsDict = None):
        acts = clip(actions, -2.0, 2.0)
        return clip(states + acts * self.dt, self.low, self.high)


@dataclasses.dataclass(frozen=True, eq=False)
class ArmProblem:
    robot: PandaRobot
    model: ArmModel
    q_start: torch.Tensor
    ee_target: torch.Tensor
    inst_cost: Callable
    term_cost: Callable
    ctrl: DuSt
    calibration_bound: Optional[float]  # z³ bound of the warm-up paths


def arm_costs(robot: PandaRobot, scene_tag: str, ee_target: torch.Tensor):
    """``(inst_cost, term_cost)`` of the flagship problem."""
    occ = sdf_occupancy(get_scene(scene_tag, device=robot.device))

    def inst_cost(states, actions=None, **_):
        xs = robot.qs_to_joints_xs(states)  # [..., 9, 3]
        col = occ(create_body_points(xs, 4)).mean(-1)
        reach = torch.sum((xs[..., -1, :] - ee_target) ** 2, dim=-1)
        c = 2.0 * col + reach
        if actions is not None:
            c = c + 0.01 * torch.sum(actions * actions, dim=-1)
        return c

    def term_cost(states, **_):
        ee = robot.qs_to_joints_xs(states)[..., -1, :]
        return 10.0 * torch.sum((ee - ee_target) ** 2, dim=-1)

    return inst_cost, term_cost


def build_arm_mpc(device=None, n_pol: int = 1024, hz_len: int = 40,
                  dyadic_order: int = 3, bandwidth: float = 4.0,
                  lr: float = 0.1, scene_tag: str = "bookshelf_small",
                  seed: int = 0, calibrate: bool = True,
                  kernel_mode: str = "signature",
                  fused_velocity: bool = False,
                  grad_precision: str = "fp32",
                  static: str = "rbf", stein_sampler: str = "SVGD",
                  kernel=None) -> ArmProblem:
    """Build the flagship problem. In signature mode the kernel's order is
    calibrated on a warm-up rollout of policies drawn from ``seed`` (the
    bound is reported either way); ``calibrate=False`` keeps
    ``dyadic_order``, as bench's pinned controller does, and
    ``grad_precision`` is the signature kernel's adjoint precision ("bf16":
    the λ=3 pair list with K6). ``static="linear"`` takes the linear static
    kernel (the bandwidth is then unused, as in the JAX package; calibrated
    to order 0 it takes the wavefront). ``kernel_mode="policy"`` gives
    bench's RBF controller, with ``fused_velocity`` selecting K9, and
    ``"trajectory"`` the kernel on each coordinate of τ; neither has a
    signature kernel to calibrate. ``kernel`` is the policy or trajectory
    kernel (a ``GaussianKernel`` when None) and ``stein_sampler`` the
    sampler ("SVGD", "ScaledSVGD" or "MatrixSVGD")."""
    device = resolve_device(device)
    robot = PandaRobot.create(device=device)
    low, high = robot.joint_limits()
    model = ArmModel(dt=0.05, low=low, high=high)
    q_start = torch.tensor(Q_START, dtype=torch.float32, device=device)
    q_target = torch.tensor(Q_TARGET, dtype=torch.float32, device=device)
    ee_target = robot.ee_position(q_target[None])[0]
    inst_cost, term_cost = arm_costs(robot, scene_tag, ee_target)
    common = dict(model=model, hz_len=hz_len, n_pol=n_pol, device=device,
                  optimizer=Adam(lr), pol_hyper_prior=True,
                  inst_cost_fn=inst_cost, term_cost_fn=term_cost,
                  stein_sampler=stein_sampler,
                  kernel=GaussianKernel() if kernel is None else kernel)
    problem = dict(robot=robot, model=model, q_start=q_start,
                   ee_target=ee_target, inst_cost=inst_cost, term_cost=term_cost)
    if kernel_mode in ("policy", "trajectory"):
        ctrl = DuSt(kernel_mode=kernel_mode, fused_velocity=fused_velocity, **common)
        return ArmProblem(ctrl=ctrl, calibration_bound=None, **problem)
    ctrl = DuSt(
        kernel_mode="signature",
        sig_kernel=SignatureKernel(dyadic_order=dyadic_order, bandwidth=bandwidth,
                                   static=static, grad_precision=grad_precision),
        **common,
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    cs0 = ctrl.init(generator=gen)
    with torch.no_grad():
        _c0, trs0 = ctrl._rollout_costs(q_start, cs0.pol_mean)
        tau0 = ctrl._tau(trs0)
    bound = float(ctrl.sig_kernel.calibration_bound(tau0))
    if calibrate:
        sig = ctrl.sig_kernel.calibrate_dyadic_order(tau0, tol=CALIBRATION_TOL)
        ctrl = dataclasses.replace(ctrl, sig_kernel=sig)
    return ArmProblem(ctrl=ctrl, calibration_bound=bound, **problem)


def build_planning_problem(device=None, scene_tag: str = "bookshelf_small",
                           timesteps: int = 200,
                           n_body_points: int = 10) -> PlanningProblem:
    """The planning problem ``bench.py`` measures: the Panda from
    ``Q_START`` to ``Q_TARGET`` through ``scene_tag`` with exact-SDF
    occupancy, ``timesteps`` spline samples and ``n_body_points`` points per
    arm segment."""
    device = resolve_device(device)
    robot = PandaRobot.create(device=device)
    return PlanningProblem(
        robot=robot,
        q_start=torch.tensor(Q_START, dtype=torch.float32, device=device),
        q_target=torch.tensor(Q_TARGET, dtype=torch.float32, device=device),
        occupancy_fn=sdf_occupancy(get_scene(scene_tag, device=device)),
        timesteps=timesteps, n_body_points=n_body_points,
    )
