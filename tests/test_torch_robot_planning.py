"""The port's arm-planning sweep against the JAX package on the CPU: the
trajectory audit on fixed knots, the request sampler on every scene tag and
one tiny sweep row (1 request, ``sgd`` and ``pathsig`` at depth 3, 3
iterations, T = 20, from JAX's initial knots: knots atol 1e-4). The audit
and the sweep row share their knots' shape [4, 3, 7] and T = 20, so JAX
compiles the audit's ops once. The models the sweep builds on are held in
``tests/test_torch_robot_models.py``.
"""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import robot_planning as jrp
from sigsvgd_tpu.experiments import verify_trajectory as jvt
from sigsvgd_tpu.experiments.planning import PlannerConfig as JPlannerConfig
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot import scene as jscene
from sigsvgd_tpu_torch.experiments import robot_planning as trp
from sigsvgd_tpu_torch.experiments import verify_trajectory as tvt
from sigsvgd_tpu_torch.experiments.planning import PlannerConfig
from sigsvgd_tpu_torch.models.robot import scene as tscene
from sigsvgd_tpu_torch.models.robot import self_collision as tsc
from sigsvgd_tpu_torch.models.robot.panda import PandaRobot

MARGIN_TOL = 1e-5


def _n(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def robots():
    return JPandaRobot.create(), PandaRobot.create(device="cpu")


def test_verify_knot_trajectories_matches_jax(robots):
    jr, tr = robots
    rng = np.random.default_rng(2)
    lo, hi = (_n(a) for a in jr.joint_limits())
    knots = rng.uniform(lo * 0.6, hi * 0.6, size=(4, 3, 7)).astype(np.float32)
    q0 = np.asarray([0.0, -0.6, 0.0, -2.0, 0.0, 1.5, 0.0], np.float32)
    q1 = np.asarray([1.2, -0.3, 0.3, -1.5, 0.2, 1.8, 0.5], np.float32)
    for tag in ("pillars_4", "table_pick"):
        aj = jvt.verify_knot_trajectories(jr, jscene.get_scene(tag), jnp.asarray(q0),
                                          jnp.asarray(q1), jnp.asarray(knots), timesteps=20)
        at = tvt.verify_knot_trajectories(tr, tscene.get_scene(tag, device="cpu"), _t(q0),
                                          _t(q1), _t(knots), timesteps=20)
        assert set(at) == set(aj)
        for k in ("collision_free", "n_valid"):
            np.testing.assert_array_equal(np.asarray(at[k]), np.asarray(aj[k]))
        for k in ("env_collision_fraction", "self_collision_fraction"):
            # the same waypoints collide: the means of 20 {0, 1} labels agree
            # to rounding (XLA's mean and torch's round apart)
            np.testing.assert_allclose(at[k], _n(aj[k]), atol=1e-6)


def test_default_requests_match_jax_on_every_tag(robots):
    """Equal on every tag at n = 2. A candidate within ``MARGIN_TOL`` of a
    threshold (clearance 0.10, smallest self-collision margin 0) may flip
    between the packages; pairing is positional, so a flip could change only
    the pair holding that candidate, which the test then allows."""
    jr, tr = robots
    for tag in jscene.SCENE_TAGS:
        want = [(r.start, r.target) for r in jrp.default_requests(jr, tag, n=2)]
        got = [(r.start, r.target) for r in trp.default_requests(tr, tag, n=2)]
        assert len(got) == 2
        if got == want:
            continue
        cands, _, clearance = trp.request_candidates(tr, tag)
        margins = tsc.self_collision_margins(tr, _t(cands)).amin(-1).numpy()
        border = (np.abs(clearance - trp.CLEARANCE) <= MARGIN_TOL) | (
            np.abs(margins) <= MARGIN_TOL)
        border_pairs = {tuple(map(float, cands[2 * j])) for j in range(len(cands) // 2)
                        if border[2 * j] or border[2 * j + 1]}
        assert ({s for s, _ in got} ^ {s for s, _ in want}) <= border_pairs, tag


def test_sweep_row_matches_jax(robots, tmp_path, monkeypatch):
    """One request of ``pillars_4``, one seed, ``sgd`` and ``pathsig`` (depth 3
    on knots [4, 3, 7]: K4's pair list, its twin here), 3 iterations, T = 20,
    both from JAX's initial knots: the saved knots atol 1e-4, the rows'
    audits equal, the end-effector length rtol 1e-4; a re-run skips the
    finished cells."""
    jr, _ = robots
    seed = trp.generate_seeds(1)[0]
    lower, upper = jr.joint_limits()
    x0 = _n(jax.random.uniform(jax.random.PRNGKey(seed), (4, 3, 7), minval=lower,
                               maxval=upper))
    run_opt = trp.run_optimisation

    def with_jax_x0(problem, cfg, generator=None):
        return run_opt(problem, cfg, generator=generator, x0=_t(x0))

    monkeypatch.setattr(trp, "run_optimisation", with_jax_x0)
    kw = dict(n_iter=3, batch=4, depth=3, timesteps=20)
    rows_j = jrp.run_experiment(["pillars_4"], ["sgd", "pathsig"], 1, tmp_path / "j",
                                JPlannerConfig(**kw), n_requests=1)
    rows_t = trp.run_experiment(["pillars_4"], ["sgd", "pathsig"], 1, tmp_path / "t",
                                PlannerConfig(**kw), n_requests=1, device="cpu")
    assert len(rows_t) == len(rows_j) == 2
    for rj, rt in zip(rows_j, rows_t):
        assert {k: rt[k] for k in ("scene", "request", "seed", "method",
                                   "n_collision_free", "success_rate")} == {
            k: rj[k] for k in ("scene", "request", "seed", "method", "n_collision_free",
                               "success_rate")}
        np.testing.assert_allclose(rt["best_ee_length"], rj["best_ee_length"], rtol=1e-4)
        cell = Path(f"robot-pillars_4/0-{seed}/{rt['method']}/data.pkl")
        dj = pickle.loads((tmp_path / "j" / cell).read_bytes())
        dt = pickle.loads((tmp_path / "t" / cell).read_bytes())
        np.testing.assert_allclose(dt["knots"], dj["knots"], atol=1e-4)
        np.testing.assert_array_equal(dt["audit"]["collision_free"],
                                      dj["audit"]["collision_free"])
    again = trp.run_experiment(["pillars_4"], ["sgd", "pathsig"], 1, tmp_path / "t",
                               PlannerConfig(**kw), n_requests=1, device="cpu")
    assert again == []
