"""The port's particle maze against the JAX package: the obstacle grid, the
point-mass model and the closed-loop episode.

* The grid, rasterised in numpy by both packages, bit for bit, for every
  preset, the maze's 0.01 m map and random obstacles from one numpy seed.
* ``get_collisions`` and ``to_map_coord`` against JAX's under ``jit`` on
  random points and on points at cell edges, exactly: XLA computes
  ``xy / cell + offset`` as one multiply-add by the fp32 reciprocal, and
  the port forms that result in fp64 rounded once (a plain fp32 division
  floors ~1 point in 2e5 into the neighbouring cell).
* ``ParticleModel.step`` (acceleration and velocity control, parameter
  broadcast, the crash freeze) and the default costs against JAX's at rtol
  1e-6, the spaces and the target.
* Episodes, JAX's draws handed to the port (``MazeDraws``) on JAX's key
  schedule: ``key, k_init = split(PRNGKey(seed))`` for the initial policies
  (``DuSt.init``), ``key, k_mpf = split(key)`` for the MPF's normals, then
  ``split(key, steps)`` and in each step ``DuSt.forward``'s own schedule.
  The 5-step ``rbf`` episode meets ``GOLDEN_MAZE_RBF_SEED42`` at that
  test's rtol 1e-4 / atol 1e-5. The ``signature`` + MPF episode at 6
  policies, H = 8, 3 steps meets JAX's ``run_episode``: trajectory and
  actions rtol 1e-4 / atol 1e-5, costs rtol 1e-4, the MPF's particles
  atol 1e-5 (on the CPU the trajectory came out bit-equal: its first steps
  commit to a frozen primitive; the particles 7.5e-7 apart). One maze
  solve off the primitives holds the updated policies
  (``test_maze_solve_matches_jax``). On the card against the CPU
  (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
  ``maze_small_vs_cpu``) an episode may part where a rollout point lies
  within an ulp of an obstacle cell's edge: a crash freezes that particle
  for the rest of its horizon and adds 1e6 to its cost.
* ``params_samples > 0``: the controller plans under draws from the MPF's
  ``ParticleGMM`` (components and normals handed over), 2 steps.
* The live plot writes its PNG, and the MPF sharded over a gloo group of 2
  CPU ranks gives the unsharded episode (``test_unported_options_raise``,
  named for the raises those options had until they were ported).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import maze as jmaze
from sigsvgd_tpu.models import ParticleModel as JParticleModel
from sigsvgd_tpu.utils import obstacle_map as jom
from sigsvgd_tpu_torch.controllers.dust import DuStDraws
from sigsvgd_tpu_torch.experiments import maze
from sigsvgd_tpu_torch.models.particle import ParticleModel
from sigsvgd_tpu_torch.utils import obstacle_map as om
from test_regression import GOLDEN_MAZE_RBF_SEED42

PRESETS = ["grid_3x3", "grid_4x4", "sm_grid_4x4", "grid_6x6", "staggered_3-2-3",
           "staggered_4-3-4-3-4", "single_centred"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("preset,size,cell,width", [
    (p, (20, 20), 0.1, 2.0) for p in PRESETS] + [
    ("sm_grid_4x4", (4, 4), 0.01, 0.6), ("single_centred", (10, 10), 0.5, 4.0)])
def test_obstacle_grid_is_bit_equal(preset, size, cell, width):
    want = jom.generate_obstacle_map(size, jom.obstacle_preset(preset, width), cell)
    got = om.generate_obstacle_map(size, om.obstacle_preset(preset, width), cell,
                                   device="cpu")
    assert om.obstacle_preset(preset, width) == jom.obstacle_preset(preset, width)
    np.testing.assert_array_equal(got.grid.numpy(), np.array(want.grid))
    assert (got.cell_size, got.offset) == (want.cell_size, want.offset)
    assert (got.xlim, got.ylim) == (want.xlim, want.ylim)


def test_random_obstacles_are_bit_equal():
    kw = dict(num_random=6, random_shape=(1.0, 1.0), with_borders=False)
    want = jom.generate_obstacle_map((10, 10), [], 0.1, rng=np.random.default_rng(3), **kw)
    got = om.generate_obstacle_map((10, 10), [], 0.1, rng=np.random.default_rng(3),
                                   device="cpu", **kw)
    np.testing.assert_array_equal(got.grid.numpy(), np.array(want.grid))
    assert got.grid.sum() > 0
    with pytest.raises(ValueError, match="Generator"):
        om.generate_obstacle_map((10, 10), [], 0.1, device="cpu", **kw)
    with pytest.raises(ValueError, match="Unknown obstacle preset"):
        om.obstacle_preset("nope")


def _maze_maps():
    args = ((4, 4), jom.obstacle_preset("sm_grid_4x4", 0.6), 0.01)
    return jom.generate_obstacle_map(*args), om.generate_obstacle_map(*args, device="cpu")


def test_collision_lookup_matches_jitted_jax():
    jmap, tmap = _maze_maps()
    rng = np.random.default_rng(0)
    xy = rng.uniform(-2.3, 2.3, (200_000, 2)).astype(np.float32)
    # points on and next to cell edges, where the rounding decides the cell
    edges = (np.arange(-230, 231) * 0.01).astype(np.float32)
    near = np.concatenate([edges, np.nextafter(edges, 10), np.nextafter(edges, -10)])
    grid_pts = np.stack(np.meshgrid(near, near[::7]), -1).reshape(-1, 2)
    for pts in (xy, grid_pts):
        want = np.array(jax.jit(lambda p: jom.get_collisions(jmap, p))(pts))
        got = om.get_collisions(tmap, torch.from_numpy(pts)).numpy()
        np.testing.assert_array_equal(got, want)
        coords = np.array(jax.jit(lambda p: jom.to_map_coord(jmap, p))(pts))
        np.testing.assert_array_equal(om.to_map_coord(tmap, torch.from_numpy(pts)).numpy(),
                                      coords)
    # the batch shape is kept, and a lookup carries no gradient
    x = torch.from_numpy(xy[:12].reshape(3, 4, 2)).requires_grad_(True)
    hit = om.get_collisions(tmap, x)
    assert hit.shape == (3, 4) and not hit.requires_grad


MODEL_CASES = {
    "maze": None,  # the maze's own model
    "accel_mass": dict(dt=0.1, mass=2.0, map_size=(4, 4), map_cell_size=0.1),
    "velocity": dict(dt=0.5, control_type="velocity", max_speed=1.0, map_size=(4, 4),
                     map_cell_size=0.1, target_state=(0.5, -0.25)),
    "crash": dict(dt=0.1, with_obstacle=True, obst_preset="single_centred",
                  obst_width=1.0, map_size=(4, 4), map_cell_size=0.05, can_crash=True,
                  max_speed=3.0, max_accel=4.0, target_state=(1.0, 1.0, 0.0, 0.0),
                  cost_params={"w_qpos": 2.0, "w_ctrl": 0.3, "w_obs": 50.0}),
}


def _models(name):
    kw = MODEL_CASES[name]
    if kw is None:
        return jmaze.make_model(jmaze.MazeConfig()), maze.make_model(maze.MazeConfig(),
                                                                     device="cpu")
    return JParticleModel.create(**kw), ParticleModel.create(device="cpu", **kw)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_particle_step_and_costs_match_jax(name):
    jm, tm = _models(name)
    rng = np.random.default_rng(1)
    n = 4 if tm.control_type == "acceleration" else 2
    s = rng.uniform(-1.9, 1.9, (64, n)).astype(np.float32)
    s[:8, :2] = 0.0  # inside the central obstacle where there is one
    a = rng.uniform(-6, 6, (64, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 3.0, (64, 1)).astype(np.float32)
    step_j = jax.jit(lambda s, a, m: (jm.step(s, a), jm.step(s, a, jm.params_to_dict(m))))
    want, want_m = step_j(s, a, mass)
    got = tm.step(_t(s), _t(a))
    got_m = tm.step(_t(s), _t(a), tm.params_to_dict(_t(mass)))
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_m.numpy(), np.array(want_m), rtol=1e-6, atol=1e-7)
    inst_j = jax.jit(lambda s, a: (jm.default_inst_cost(s, a), jm.default_inst_cost(s),
                                   jm.default_term_cost(s)))(s, a)
    inst_t = (tm.default_inst_cost(_t(s), _t(a)), tm.default_inst_cost(_t(s)),
              tm.default_term_cost(_t(s)))
    for g, w in zip(inst_t, inst_j):
        np.testing.assert_allclose(g.numpy(), np.array(w), rtol=1e-6)
    if tm.can_crash:
        np.testing.assert_array_equal(got[:8].numpy(), s[:8])  # frozen in place
    for sp in ("observation_space", "action_space"):
        js, ts = getattr(jm, sp), getattr(tm, sp)
        assert (ts.dim, ts.low_t, ts.high_t) == (js.dim, js.low_t, js.high_t)
    np.testing.assert_array_equal(tm.target.numpy(), np.array(jm.target))
    # a noisy model without a generator steps as the deterministic one
    noisy = dataclasses.replace(tm, deterministic=False, noise_std=(0.5, 0.5))
    torch.testing.assert_close(noisy.step(_t(s), _t(a)), got, rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(noisy.step(_t(s), _t(a), generator=g), got)


def test_particle_step_is_differentiable_in_the_mass():
    """The MPF's score: autograd through the step in the mass, against
    ``jax.grad``."""
    jm, tm = _models("maze")
    rng = np.random.default_rng(2)
    s = np.tile(np.array([[-1.85, -1.85, 0.3, -0.2]], np.float32), (8, 1))
    a = np.tile(rng.uniform(-8, 8, (1, 2)).astype(np.float32), (8, 1))
    m = rng.uniform(1.0, 3.0, (8, 1)).astype(np.float32)

    def f_j(m):
        return jnp.sum(jm.step(s, a, jm.params_to_dict(m)) ** 2)

    mt = _t(m).requires_grad_(True)
    (g,) = torch.autograd.grad((tm.step(_t(s), _t(a), tm.params_to_dict(mt)) ** 2).sum(), mt)
    np.testing.assert_allclose(g.numpy(), np.array(jax.grad(f_j)(m)), rtol=1e-5)


def jax_maze_draws(cfg: maze.MazeConfig, seed: int) -> maze.MazeDraws:
    """Every draw JAX's ``run_episode`` makes (see the module docstring), as
    the port's ``MazeDraws``; ``cfg.steps`` step draws."""
    jcfg = jmaze.MazeConfig(**dataclasses.asdict(cfg))
    jctrl = jmaze.build_controller(jcfg, jmaze.make_model(jcfg))
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    pol = jctrl.init(k_init, action_primitives=jmaze.action_primitives(cfg.horizon)).pol_mean
    mpf_init = None
    if cfg.use_mpf:
        key, k_mpf = jax.random.split(key)
        mpf_init = _t(jax.random.normal(k_mpf, (cfg.mpf_n_particles, 1), jnp.float32))
    n_total = cfg.n_policies + maze.N_PRIM
    steps = []
    for k in jax.random.split(key, cfg.steps):
        k, key_par = jax.random.split(k)
        keys = jax.random.split(k, cfg.opt_steps + 1)[: cfg.opt_steps]
        shape = (cfg.action_samples, n_total, cfg.horizon, 2)
        actions = _t(np.stack([np.array(jax.random.normal(kt, shape, jnp.float32))
                               for kt in keys]))
        params = comps = None
        P = cfg.params_samples
        if P and cfg.use_mpf:
            key_c, key_n = jax.random.split(key_par)
            comps = _t(jax.random.categorical(key_c, jnp.zeros(cfg.mpf_n_particles),
                                              shape=(P,)))
            params = _t(jax.random.normal(key_n, (P, 1), jnp.float32))
        elif P:
            params = _t(jax.random.normal(key_par, (P, 1), jnp.float32))
        steps.append(DuStDraws(actions=actions, params=params, params_comps=comps))
    return maze.MazeDraws(pol_mean=_t(pol[maze.N_PRIM:]), mpf_init=mpf_init, steps=steps)


def test_rbf_episode_meets_the_golden_trajectory():
    """``tests/test_regression.py::test_maze_rbf_golden_trajectory`` on the
    port, with JAX's draws for seed 42."""
    cfg = maze.MazeConfig(kernel="rbf", steps=5)
    res = maze.run_episode(cfg, 42, device="cpu", draws=jax_maze_draws(cfg, 42))
    np.testing.assert_allclose(res["trajectory"], GOLDEN_MAZE_RBF_SEED42, rtol=1e-4,
                               atol=1e-5)
    assert res["steps"] == 5 and not res["reached_goal"] and res["dyn_particles"] is None


@pytest.mark.parametrize("case", ["signature_mpf", "rbf_mpf_params"])
def test_reduced_episode_matches_jax(case):
    if case == "signature_mpf":
        cfg = maze.MazeConfig(kernel="signature", use_mpf=True, n_policies=6,
                              horizon=8, steps=3)
    else:
        cfg = maze.MazeConfig(kernel="rbf", use_mpf=True, n_policies=6, horizon=8,
                              steps=2, params_samples=3)
    want = jmaze.run_episode(jmaze.MazeConfig(**dataclasses.asdict(cfg)), 7)
    got = maze.run_episode(cfg, 7, device="cpu", draws=jax_maze_draws(cfg, 7))
    assert got["steps"] == want["steps"] == cfg.steps
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["actions"], want["actions"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-4)
    np.testing.assert_allclose(got["dyn_particles"], want["dyn_particles"], rtol=0,
                               atol=1e-5)
    assert got["reached_goal"] == want["reached_goal"]


@pytest.mark.parametrize("kernel", ["signature", "rbf"])
def test_maze_solve_matches_jax(kernel):
    """One maze solve off the primitives (which the first steps of a short
    episode commit to): 6 policies, H = 12, from a state beside an obstacle,
    given JAX's draws. The costs rtol 1e-5, the weights rtol 1e-4 and their
    argmax; the new policies and the action on elements whose last Adam step
    is not near 0 (|Δ| > 1e-3), atol 1e-4 with the RBF kernel and 5e-4 with
    the signature kernel: JAX's λ=3 Gram takes its dense route on the CPU,
    the port K2's twin, and their repulsions are each within K2's scaled
    4e-4 of fp64 (``K2_TOL``); Adam at lr 1 passes such an error on at about
    its size (2.0e-4 measured on the CPU)."""
    cfg = maze.MazeConfig(kernel=kernel, n_policies=6, horizon=12, steps=1)
    jcfg = jmaze.MazeConfig(**dataclasses.asdict(cfg))
    jctrl = jmaze.build_controller(jcfg, jmaze.make_model(jcfg))
    tctrl = maze.build_controller(cfg, maze.make_model(cfg, "cpu"))
    draws = jax_maze_draws(cfg, 3)
    prims = jmaze.action_primitives(cfg.horizon)
    js = jctrl.init(jax.random.PRNGKey(0), pol_mean=jnp.asarray(draws.pol_mean.numpy()),
                    action_primitives=prims)
    ts = tctrl.init(pol_mean=draws.pol_mean, action_primitives=_t(prims))
    x = np.array([-1.2, -1.75, 1.5, 0.4], np.float32)  # below the corner obstacle
    key = jax.random.split(jax.random.split(jax.random.PRNGKey(3))[0], 1)[0]
    a_j, js2, data_j = jax.jit(lambda s, c, k: jctrl.forward(s, c, None, k, opt_steps=2))(
        jnp.asarray(x), js, key)
    a_t, ts2, data_t = tctrl.forward(_t(x), ts, None, opt_steps=2, draws=draws.steps[0])
    np.testing.assert_allclose(data_t.costs.numpy(), np.array(data_j.costs), rtol=1e-5)
    assert int(torch.argmax(data_t.pol_weights)) == int(np.argmax(data_j.pol_weights))
    np.testing.assert_allclose(data_t.pol_weights.numpy(), np.array(data_j.pol_weights),
                               rtol=1e-4, atol=1e-7)
    step = (data_t.trace[-1] - data_t.trace[-2]).abs()
    keep = torch.cat([step[:, 1:], step[:, -1:]], 1) > 1e-3  # rolled by one
    got, want = ts2.pol_mean.numpy(), np.array(js2.pol_mean)
    assert keep[maze.N_PRIM:].float().mean() > 0.9
    atol = 5e-4 if kernel == "signature" else 1e-4
    np.testing.assert_allclose(got[keep.numpy()], want[keep.numpy()], rtol=0, atol=atol)
    np.testing.assert_allclose(a_t.numpy(), np.array(a_j), rtol=0, atol=atol)


def test_episode_draws_from_its_generator_and_repeats():
    cfg = maze.MazeConfig(kernel="rbf_fixed_bw", use_mpf=True, n_policies=4, horizon=6,
                          steps=2, mpf_steps=3)
    a = maze.run_episode(cfg, 5, device="cpu")
    b = maze.run_episode(cfg, 5, device="cpu")
    c = maze.run_episode(cfg, 6, device="cpu")
    np.testing.assert_array_equal(a["trajectory"], b["trajectory"])
    np.testing.assert_array_equal(a["dyn_particles"], b["dyn_particles"])
    assert not np.allclose(a["dyn_particles"], c["dyn_particles"])
    assert a["dyn_particles"].shape == (2, 50, 1)
    with pytest.raises(ValueError, match="draws given for 1 steps"):
        maze.run_episode(cfg, 5, device="cpu",
                         draws=jax_maze_draws(dataclasses.replace(cfg, steps=1), 5))


@pytest.mark.parametrize("field,value,name", [
    ("live_plot", "cost.png", "M14"), ("mpf_mesh_devices", 2, "M15")])
def test_unported_options_raise(field, value, name, tmp_path):
    """The two options that raised until their modules were ported (M14's
    live plot, M15's sharded MPF) now run. ``live_plot`` writes its PNG;
    ``mpf_mesh_devices=2`` raises without a process group of 2 ranks and,
    on a gloo group of 2 CPU ranks (``tests/_torch_dist_ranks.py``), gives
    the unsharded episode (trajectory and particles at the sharded MPF's
    1e-4 / 1e-5, ``tests/test_parallel_mpf.py``)."""
    cfg = maze.MazeConfig(kernel="rbf_fixed_bw", use_mpf=True, n_policies=4, horizon=6,
                          steps=3, mpf_steps=3)
    if field == "live_plot":
        png = tmp_path / value
        out = maze.run_episode(dataclasses.replace(cfg, live_plot=str(png)), 5, device="cpu")
        assert png.stat().st_size > 0 and out["steps"] == 3
        return
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        maze.run_episode(dataclasses.replace(cfg, mpf_mesh_devices=value), 5, device="cpu")
    from _torch_dist_ranks import result, start_ranks

    out = result(start_ranks(value, [(name, "case_maze", dict(
        cfg=dataclasses.asdict(cfg), seed=5))], tmp_path).join(), name)
    assert out["sharded"]["dyn_particles"].shape == (3, 50, 1)
    for k in ("trajectory", "dyn_particles", "actions"):
        np.testing.assert_allclose(out["sharded"][k], out["single"][k], rtol=1e-4, atol=1e-5)


def test_config_defaults_match_jax():
    assert dataclasses.asdict(maze.MazeConfig()) == dataclasses.asdict(jmaze.MazeConfig())
    np.testing.assert_array_equal(maze.action_primitives(7, "cpu").numpy(),
                                  np.array(jmaze.action_primitives(7)))
    with pytest.raises(ValueError, match="invalid kernel"):
        maze.build_controller(maze.MazeConfig(kernel="x"),
                              maze.make_model(maze.MazeConfig(), "cpu"))


def test_main_runs_on_the_cpu(tmp_path, capsys):
    maze.main(["--kernel", "rbf", "--steps", "1", "--device", "cpu",
               "--out", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"steps": 1' in line
    from sigsvgd_tpu_torch.utils.helper import load_progress

    data = load_progress(tmp_path / "ep0")
    assert data["trajectory"].shape == (2, 4)
