"""The port's L-BFGS planning run (``PlannerConfig(optimizer="lbfgs")``,
whose ``value_fn`` is the summed planning cost) against the JAX package's on
the CPU, as ``tests/test_planning.py::test_planning_with_lbfgs_linesearch``
runs it: 2 iterations from JAX's knots (``svgd`` at the fixed bandwidth,
T = 20), knots and losses within rtol 1e-4 / atol 1e-5, the chained-run
tolerance of ``tests/test_planning.py``. Its own file: JAX's compile of the
L-BFGS planning step takes most of its time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sigsvgd_tpu.experiments import planning as jplan
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot.scene import get_scene as j_get_scene
from sigsvgd_tpu_torch.experiments import planning as tplan
from sigsvgd_tpu_torch.experiments.arm_mpc import Q_START, Q_TARGET, build_planning_problem

CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)


def test_lbfgs_planning_run_matches_jax(rng):
    T = 20
    jp = jplan.PlanningProblem(
        robot=JPandaRobot.create(), q_start=jnp.asarray(Q_START, jnp.float32),
        q_target=jnp.asarray(Q_TARGET, jnp.float32),
        occupancy_fn=jplan.sdf_occupancy(j_get_scene("bookshelf_small")),
        timesteps=T, n_body_points=3)
    tp = build_planning_problem(device="cpu", timesteps=T, n_body_points=3)
    lower, upper = (t.numpy() for t in tp.robot.joint_limits())
    x0 = (lower + (upper - lower) * rng.uniform(size=(4, 3, 7))).astype(np.float32)
    cfg = dict(method="svgd", n_iter=2, batch=4, timesteps=T, optimizer="lbfgs")
    xj, dj = jplan.run_optimisation(jp, jplan.PlannerConfig(**cfg), jax.random.PRNGKey(0),
                                    x0=jnp.asarray(x0))
    xt, dt = tplan.run_optimisation(tp, tplan.PlannerConfig(**cfg), x0=torch.from_numpy(x0))
    assert bool(torch.isfinite(xt).all()) and not np.allclose(xt.numpy(), x0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **CHAIN_TOL)
    np.testing.assert_allclose(dt.loss.numpy(), np.asarray(dj.loss), **CHAIN_TOL)
