"""The port's MPF, its likelihoods and the runners' helpers against the JAX
package.

* ``GaussianLikelihood`` (``condition``, ``sample`` in linear and log space,
  ``log_prob``) and ``ExponentiatedUtility`` at rtol 1e-6.
* ``MPF.init``, ``prior_log_prob`` and ``observe`` on the same particles
  and transitions: ``tests/test_mpf.py``'s point mass (mass 2, obs std
  0.05, lr 0.05, bw 0.3) and the maze's MPF (log space, obs std 0.1, lr
  0.01, bw 0.5, on the maze's model with its obstacle grid), each over
  chained observes with ``n_steps`` Stein steps, and Silverman's bandwidth
  (``bw=None``, scaled tenfold): particles, φ's norms and the prior's
  bandwidth at rtol 1e-5 / atol 1e-6 after the first observe and rtol
  5e-5 after later ones (the point mass's sharp likelihood, obs std 0.05 at
  lr 0.05, amplifies an ulp about threefold an observe: 1.8e-6 after one,
  2.2e-5 after three on the CPU). ``jax.grad`` of the log posterior
  against the port's autograd score, rtol 1e-5.
* ``test_mpf.py``'s convergence run (30 transitions, the actions JAX draws)
  on the port: the estimate within 0.3 of the true mass, as there.
* ``generate_seeds``, ``save_progress``/``load_progress`` and
  ``assert_finite_pytree`` (the same leaf paths named as JAX's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import maze as jmaze
from sigsvgd_tpu.inference import MPF as JMPF
from sigsvgd_tpu.inference import GaussianLikelihood as JLik
from sigsvgd_tpu.inference.likelihoods import ExponentiatedUtility as JUtility
from sigsvgd_tpu.kernels import GaussianKernel as JGaussianKernel
from sigsvgd_tpu.models import ParticleModel as JParticleModel
from sigsvgd_tpu.utils import helper as jhelper
from sigsvgd_tpu_torch.experiments import maze
from sigsvgd_tpu_torch.inference.likelihoods import (
    ExponentiatedUtility, GaussianLikelihood, GaussianObs,
)
from sigsvgd_tpu_torch.inference.mpf import MPF, MPFState
from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
from sigsvgd_tpu_torch.models.particle import ParticleModel
from sigsvgd_tpu_torch.utils import helper

TRUE_MASS = 2.0
POINT_MASS = dict(dt=0.1, mass=TRUE_MASS, control_type="acceleration",
                  map_size=(10, 10), map_cell_size=0.5, max_speed=50.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _filters(case: str, bw="fixed"):
    if case == "point_mass":
        jm, tm = JParticleModel.create(**POINT_MASS), ParticleModel.create(device="cpu",
                                                                           **POINT_MASS)
        lik_kw, mpf_kw = dict(obs_std=0.05, log_space=False), dict(lr=0.05, bw=0.3)
    else:
        jm = jmaze.make_model(jmaze.MazeConfig())
        tm = maze.make_model(maze.MazeConfig(), "cpu")
        lik_kw, mpf_kw = dict(obs_std=0.1, log_space=True), dict(lr=0.01, bw=0.5)
    if bw == "silverman":
        # Silverman's bandwidth at these spreads is ~0.016-0.06, where the
        # filter's steps blow up (|φ| 7 → 58 in 3 steps) and amplify an ulp
        # without bound; scaled tenfold it is stable
        mpf_kw.update(bw=None, bw_scale=10.0)
    jf = JMPF(likelihood=JLik(step_fn=jm.step, params_to_dict=jm.params_to_dict, **lik_kw),
              kernel=JGaussianKernel(), **mpf_kw)
    tf = MPF(likelihood=GaussianLikelihood(step_fn=tm.step,
                                           params_to_dict=tm.params_to_dict, **lik_kw),
             kernel=GaussianKernel(), **mpf_kw)
    return jm, tm, jf, tf


def test_likelihoods_match_jax():
    jm, tm, _, _ = _filters("maze")
    rng = np.random.default_rng(0)
    theta = rng.normal(0.7, 0.1, (9, 1)).astype(np.float32)
    s0 = np.array([-1.85, -1.85, 0.2, 0.1], np.float32)
    s1 = np.array([-1.84, -1.85, 0.5, 0.1], np.float32)
    act = np.array([3.0, -1.0], np.float32)
    for log_space in (False, True):
        jl = JLik(step_fn=jm.step, params_to_dict=jm.params_to_dict, obs_std=0.1,
                  log_space=log_space)
        tl = GaussianLikelihood(step_fn=tm.step, params_to_dict=tm.params_to_dict,
                                obs_std=0.1, log_space=log_space)
        jc = jl.condition(jnp.asarray(act), jnp.asarray(s1),
                          prev=jl.condition(jnp.zeros(2), jnp.asarray(s0)))
        tc = tl.condition(_t(act), _t(s1), prev=tl.condition(torch.zeros(2), _t(s0)))
        for g, w in zip(tc, jc):
            np.testing.assert_array_equal(g.numpy(), np.array(w))
        pred_j = jax.jit(jl.sample)(jnp.asarray(theta), jc)
        pred_t = tl.sample(_t(theta), tc)
        np.testing.assert_allclose(pred_t.numpy(), np.array(pred_j), rtol=1e-6)
        np.testing.assert_allclose(tl.log_prob(pred_t, tc).numpy(),
                                   np.array(jl.log_prob(pred_j, jc)), rtol=1e-6)
    assert isinstance(tc, GaussianObs)
    costs = rng.uniform(0, 50, 7).astype(np.float32)
    for c in (costs, costs[:1]):
        np.testing.assert_allclose(ExponentiatedUtility(0.5).log_p(_t(c)).numpy(),
                                   np.array(JUtility(0.5).log_p(jnp.asarray(c))), rtol=1e-6)


@pytest.mark.parametrize("case,bw,n_obs,n_steps", [
    ("point_mass", "fixed", 4, 20), ("maze", "fixed", 4, 20),
    ("point_mass", "silverman", 4, 10), ("maze", "silverman", 4, 10)])
def test_observe_matches_jax(case, bw, n_obs, n_steps):
    jm, tm, jf, tf = _filters(case, bw)
    rng = np.random.default_rng(1)
    k = 40 if case == "point_mass" else 50
    if case == "maze":
        particles = np.log(rng.normal(2.0, 0.1, (k, 1))).astype(np.float32)
        state = np.array([-1.85, -1.85, 0.0, 0.0], np.float32)
    else:
        particles = rng.normal(1.0, 0.2, (k, 1)).astype(np.float32)
        state = np.zeros(4, np.float32)
    js, ts = jf.init(jnp.asarray(particles), jnp.asarray(state)), tf.init(_t(particles),
                                                                          _t(state))
    assert isinstance(ts, MPFState)
    np.testing.assert_allclose(float(ts.prior_bw), float(js.prior_bw), rtol=1e-6)
    theta = rng.normal(0.5, 0.5, (6, 1)).astype(np.float32)
    np.testing.assert_allclose(tf.prior_log_prob(ts, _t(theta)).numpy(),
                               np.array(jf.prior_log_prob(js, jnp.asarray(theta))), rtol=1e-6)
    observe = jax.jit(lambda st, a, o: jf.observe(st, a, o, n_steps=n_steps))
    for i in range(n_obs):
        action = rng.uniform(-3.0, 3.0, 2).astype(np.float32)
        nxt = np.array(jm.step(jnp.asarray(state)[None], jnp.asarray(action)[None])[0])
        js, norms_j = observe(js, jnp.asarray(action), jnp.asarray(nxt))
        ts, norms_t = tf.observe(ts, _t(action), _t(nxt), n_steps=n_steps)
        rtol = 1e-5 if i == 0 else 5e-5
        np.testing.assert_allclose(ts.particles.numpy(), np.array(js.particles), rtol=rtol,
                                   atol=1e-6, err_msg=f"observe {i}")
        np.testing.assert_allclose(norms_t.numpy(), np.array(norms_j), rtol=rtol, atol=1e-6)
        np.testing.assert_allclose(float(ts.prior_bw), float(js.prior_bw), rtol=rtol)
        np.testing.assert_array_equal(ts.prior_means.numpy(), ts.particles.numpy())
        state = nxt
    assert norms_t.shape == (n_steps,)


def test_score_is_the_log_posterior_gradient():
    """The score, autograd on a fresh leaf, against ``jax.grad`` of the same
    log posterior; the particles given stay without a graph."""
    jm, tm, jf, tf = _filters("maze")
    rng = np.random.default_rng(2)
    particles = np.log(rng.normal(2.0, 0.1, (12, 1))).astype(np.float32)
    s0 = np.array([-1.5, -1.85, 0.4, 0.2], np.float32)
    js = jf.init(jnp.asarray(particles), jnp.asarray(s0))
    ts = tf.init(_t(particles), _t(s0))
    cond_j = jf.likelihood.condition(jnp.asarray([4.0, 1.0]), jnp.asarray(s0 + 0.01),
                                     prev=js.cond)
    cond_t = tf.likelihood.condition(torch.tensor([4.0, 1.0]), _t(s0 + 0.01), prev=ts.cond)
    js, ts = js._replace(cond=cond_j), ts._replace(cond=cond_t)

    def log_post(theta):
        pred = jf.likelihood.sample(theta, js.cond)
        return (jnp.sum(jf.likelihood.log_prob(pred, js.cond))
                + jnp.sum(jf.prior_log_prob(js, theta)))

    want = np.array(jax.jit(jax.grad(log_post))(jnp.asarray(particles)))
    x = _t(particles)
    score = tf._score(x, ts)
    np.testing.assert_allclose(score.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    assert not score.requires_grad and not x.requires_grad


def test_port_mpf_converges_to_true_mass():
    """``tests/test_mpf.py::test_mpf_converges_to_true_mass`` on the port,
    with the prior particles and actions JAX draws there."""
    _, tm, _, tf = _filters("point_mass")
    key = jax.random.PRNGKey(0)
    particles = _t(1.0 + 0.2 * jax.random.normal(key, (40, 1)))
    state = torch.zeros(4)
    ms = tf.init(particles, state)
    for k in jax.random.split(key, 30):
        action = _t(jax.random.uniform(k, (2,), minval=-3.0, maxval=3.0))
        nxt = tm.step(state[None], action[None])[0]
        ms, norms = tf.observe(ms, action, nxt, n_steps=20)
        state = nxt
    est = float(ms.particles.mean())
    assert abs(est - TRUE_MASS) < 0.3, f"MPF estimate {est} vs true {TRUE_MASS}"
    assert torch.isfinite(norms).all()


def test_helpers_match_jax(tmp_path):
    assert helper.generate_seeds(5) == jhelper.generate_seeds(5)
    assert helper.generate_seeds(3, root_seed=7) == jhelper.generate_seeds(3, root_seed=7)
    data = {"trajectory": torch.arange(6.0).reshape(3, 2), "steps": 3,
            "obs": GaussianObs(torch.zeros(2), torch.ones(1), torch.full((2,), 2.0)),
            "lists": [np.ones(2), (torch.tensor([1.5]),)]}
    helper.save_progress(tmp_path / "run", data=data, config={"seed": 1, "path": tmp_path})
    back = helper.load_progress(tmp_path / "run")
    np.testing.assert_array_equal(back["trajectory"], np.arange(6.0).reshape(3, 2))
    assert isinstance(back["obs"], GaussianObs) and back["steps"] == 3
    assert (tmp_path / "run" / "config.json").exists()
    helper.assert_finite_pytree(data)
    bad = {"a": torch.tensor([1.0, float("nan")]), "b": [np.ones(2), np.array([np.inf])],
           "c": GaussianObs(torch.zeros(1), torch.tensor([float("inf")]), torch.zeros(1)),
           "d": torch.tensor([1, 2])}
    jbad = {"a": jnp.array([1.0, jnp.nan]), "b": [np.ones(2), np.array([np.inf])],
            "c": GaussianObs(jnp.zeros(1), jnp.array([jnp.inf]), jnp.zeros(1)),
            "d": jnp.array([1, 2])}
    with pytest.raises(FloatingPointError) as got:
        helper.assert_finite_pytree(bad, "res")
    with pytest.raises(FloatingPointError) as want:
        jhelper.assert_finite_pytree(jbad, "res")
    assert str(got.value) == str(want.value)
