"""The port's checkpoints (``utils/checkpoint.py`` on ``torch.save``) and the
checkpointed planning and maze runs, on the CPU.

* The round trip of ``tests/test_harness.py::test_checkpoint_roundtrip``,
  and of NamedTuple states into a template's structure and dtypes;
  ``latest_checkpoint`` by step number.
* A planning run stopped at a checkpoint and resumed gives the
  uninterrupted run's knots bit for bit (``sgd``, and L-BFGS, whose state
  goes through the checkpoint), and the JAX package's checkpointed ``sgd``
  run from the same knots within ``tests/test_planning.py``'s rtol 1e-4 /
  atol 1e-5; a call on a finished directory returns the saved knots with an
  empty loss; ``ps_sgd`` ignores the directory, as in the JAX package.
* A maze episode (signature kernel, MPF on, action samples drawn from the
  episode's generator) stopped at step 4 and resumed to 6 equals the
  uninterrupted episode bit for bit (``tests/test_experiments.py::
  test_maze_checkpoint_resume`` holds JAX's at rtol 1e-4 / atol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import planning as jplan
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot.scene import get_scene as j_get_scene
from sigsvgd_tpu_torch.experiments import maze
from sigsvgd_tpu_torch.experiments import planning as tplan
from sigsvgd_tpu_torch.experiments.arm_mpc import Q_START, Q_TARGET, build_planning_problem
from sigsvgd_tpu_torch.inference.svgd import AdamState, SVGDState, lbfgs
from sigsvgd_tpu_torch.utils.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)

T = 20


@pytest.fixture(scope="module")
def problem():
    return build_planning_problem(device="cpu", timesteps=T, n_body_points=3)


def _knots(problem, seed=0, batch=4):
    lower, upper = (t.numpy() for t in problem.robot.joint_limits())
    u = np.random.default_rng(seed).uniform(size=(batch, 3, 7))
    return torch.from_numpy((lower + (upper - lower) * u).astype(np.float32))


def test_checkpoint_roundtrip(tmp_path):
    state = {"particles": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "step": torch.tensor(7)}
    p = tmp_path / "ckpt" / "step_7"
    save_checkpoint(p, state)
    restored = restore_checkpoint(p)
    assert torch.equal(restored["particles"], state["particles"])
    assert latest_checkpoint(tmp_path / "ckpt").name == "step_7"
    # NamedTuples into the template's structure, dtypes and devices
    x = torch.randn(3, 4, 2, dtype=torch.float64)
    opt = lbfgs(memory_size=3).init(x.float())
    tree = {"x": x, "opt": opt, "svgd": SVGDState(opt_state=AdamState(
        torch.tensor(2, dtype=torch.int32), x.float(), x.float() ** 2), step=torch.tensor(5)),
        "gen": torch.Generator().manual_seed(3).get_state(), "empty": ()}
    save_checkpoint(tmp_path / "tree", tree)
    plain = restore_checkpoint(tmp_path / "tree")
    assert isinstance(plain["opt"], list) and set(plain["opt"][0]) >= {"count", "params"}
    back = restore_checkpoint(tmp_path / "tree", tree)
    assert type(back["opt"][0]) is type(opt[0]) and type(back["svgd"].opt_state) is AdamState
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a float32 template turns a saved float64 tensor into float32
    again = restore_checkpoint(tmp_path / "tree", {**tree, "x": x.float()})
    assert again["x"].dtype == torch.float32
    with pytest.raises(FileExistsError):
        save_checkpoint(tmp_path / "tree", tree, force=False)


def test_latest_checkpoint_orders_by_step(tmp_path):
    assert latest_checkpoint(tmp_path / "missing") is None
    assert latest_checkpoint(tmp_path) is None
    for n in (2, 10, 9):
        save_checkpoint(tmp_path / f"step_{n}", {"n": torch.tensor(n)})
    (tmp_path / "notes").mkdir()
    (tmp_path / "step_99.txt").write_text("not a checkpoint")
    assert latest_checkpoint(tmp_path).name == "step_10"
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())


@pytest.mark.parametrize("optimizer", ["raw", "lbfgs"])
def test_planning_resume_is_bit_equal(problem, tmp_path, optimizer):
    x0 = _knots(problem)
    cfg = tplan.PlannerConfig(method="sgd", n_iter=4, batch=4, timesteps=T,
                              optimizer=optimizer)
    x_full, d_full = tplan.run_optimisation(problem, cfg, x0=x0)
    ck = tmp_path / "ck"
    tplan.run_optimisation(problem, dataclasses.replace(cfg, n_iter=2), x0=x0,
                           checkpoint_dir=str(ck), checkpoint_every=2)
    assert latest_checkpoint(ck).name == "step_2"
    x_res, d_res = tplan.run_optimisation(problem, cfg, x0=x0, checkpoint_dir=str(ck),
                                          checkpoint_every=2)
    assert torch.equal(x_res, x_full)
    assert torch.equal(d_res.trace, torch.stack([x0, x_full]))
    assert torch.equal(d_res.loss, d_full.loss[2:])
    # a finished run restores and returns its knots, with an empty loss
    x_again, d_again = tplan.run_optimisation(problem, cfg, x0=x0, checkpoint_dir=str(ck),
                                              checkpoint_every=2)
    assert torch.equal(x_again, x_full) and d_again.loss.shape == (0,)
    assert sorted(p.name for p in ck.iterdir()) == ["step_2", "step_4"]


def test_planning_resume_matches_jax(problem, tmp_path):
    """``test_planning_checkpoint_resume`` on both packages from the same
    knots: 2 iterations, then a resume to 4, with checkpoints every 2."""
    jp = jplan.PlanningProblem(
        robot=JPandaRobot.create(), q_start=jnp.asarray(Q_START, jnp.float32),
        q_target=jnp.asarray(Q_TARGET, jnp.float32),
        occupancy_fn=jplan.sdf_occupancy(j_get_scene("bookshelf_small")),
        timesteps=T, n_body_points=3)
    x0 = _knots(problem, seed=1)
    out = {}
    for name, pkg, prob, x in (("jax", jplan, jp, jnp.asarray(x0.numpy())),
                               ("torch", tplan, problem, x0)):
        ck = str(tmp_path / name)
        extra = (jax.random.PRNGKey(3),) if name == "jax" else ()
        for n in (2, 4):
            cfg = pkg.PlannerConfig(method="sgd", n_iter=n, batch=4, timesteps=T)
            xf, data = pkg.run_optimisation(prob, cfg, *extra, x0=x, checkpoint_dir=ck,
                                            checkpoint_every=2)
        out[name] = (np.asarray(xf), np.asarray(data.loss))
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-4, atol=1e-5)


def test_ps_sgd_ignores_the_checkpoint_dir(problem, tmp_path):
    x0 = _knots(problem)
    cfg = tplan.PlannerConfig(method="ps_sgd", n_iter=4, batch=4, timesteps=T, depth=2)
    xa, _ = tplan.run_optimisation(problem, cfg, x0=x0)
    xb, (d1, d2) = tplan.run_optimisation(problem, cfg, x0=x0,
                                          checkpoint_dir=str(tmp_path / "ck"))
    assert torch.equal(xa, xb) and not (tmp_path / "ck").exists()
    assert d1.loss.shape[0] == 3 and d2.loss.shape[0] == 1


def test_maze_resume_is_bit_equal(tmp_path):
    cfg = maze.MazeConfig(kernel="signature", use_mpf=True, n_policies=4, horizon=6,
                          action_samples=3, steps=6, mpf_steps=3)
    full = maze.run_episode(cfg, 7, device="cpu")
    ck = str(tmp_path / "ck")
    part = maze.run_episode(dataclasses.replace(cfg, steps=4, checkpoint_dir=ck,
                                                checkpoint_every=2), 7, device="cpu")
    assert part["steps"] == 4 and latest_checkpoint(ck).name == "step_4"
    resumed = maze.run_episode(dataclasses.replace(cfg, checkpoint_dir=ck,
                                                   checkpoint_every=2), 7, device="cpu")
    assert resumed["steps"] == full["steps"] == 6
    for k in ("trajectory", "actions", "costs", "dyn_particles"):
        np.testing.assert_array_equal(resumed[k], full[k])
    np.testing.assert_array_equal(part["trajectory"], full["trajectory"][:5])
