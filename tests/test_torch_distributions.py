"""The port's sampling and parameter plumbing against the JAX package:
``utils/math`` (the GMM density, its exact gradient, ``cholesky_psd``),
``utils/distributions`` (``Gaussian``, ``ParticleGMM``, ``sample``,
``log_prob``, ``moments``, ``sample_rejection``), ``Box.shape`` and
``Box.sample``, ``DynamicsModel``'s uncertain parameters, and SVGD's
``gradient_mask``, Adagrad and ``roll_opt_state``.

``jax.random`` and torch draw different numbers, so the JAX draws are
taken here with ``jax.random`` on the JAX functions' own key schedule and
handed to the port's samplers as given draws; the results are then held
against JAX's. The port's own draws (from a ``torch.Generator``) are held
to the JAX tests' statistical checks.

Tolerances: the GMM density and its exact gradient rtol 1e-4, atol 1e-5
(``tests/test_math.py``'s density check; its gradient check is a finite
difference at rtol 1e-2); ``cholesky_psd`` the same; samples from given
draws rtol 1e-5, atol 1e-6 (fp32 arithmetic on equal inputs), the GMM
resample bit for bit; ``log_prob`` rtol 1e-4 (``tests/test_utils.py``);
the statistical checks as ``tests/test_utils.py`` and
``tests/test_harness.py`` make them (mean and covariance atol 0.05 at 5000
draws, mixture mean atol 0.1, per-component std in (0.8, 1.2)); the
parameter rollout rtol 1e-5 (``tests/test_models.py``); SVGD runs of 20
steps rtol 1e-4, atol 1e-5, and frozen particles atol 1e-6
(``tests/test_svgd.py``).
"""
import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigsvgd_tpu.inference import SVGD as JSVGD
from sigsvgd_tpu.inference import ScoreResult as JScoreResult
from sigsvgd_tpu.inference.svgd import roll_opt_state as j_roll_opt_state
from sigsvgd_tpu.kernels import GaussianKernel as JGaussianKernel
from sigsvgd_tpu.models.base import DynamicsModel as JDynamicsModel
from sigsvgd_tpu.models.rollout import rollout as jrollout
from sigsvgd_tpu.utils import distributions as jdu
from sigsvgd_tpu.utils import math as jm
from sigsvgd_tpu.utils.spaces import Box as JBox
from sigsvgd_tpu_torch.inference.svgd import SVGD, Adam, ScoreResult, roll_opt_state
from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
from sigsvgd_tpu_torch.models.base import DynamicsModel
from sigsvgd_tpu_torch.models.rollout import rollout
from sigsvgd_tpu_torch.utils import distributions as du
from sigsvgd_tpu_torch.utils import math as tm
from sigsvgd_tpu_torch.utils.spaces import Box

TARGET = (1.0, -0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.array(a)


# -- a double integrator in the plane with uncertain mass and drag, in both
# packages (tests/test_torch_dust_mc.py drives DuSt on it) ------------------

@dataclasses.dataclass(frozen=True)
class JPointMass(JDynamicsModel):
    mass: float = 1.0
    drag: float = 0.1
    uncertain_params: Tuple[str, ...] = ("mass", "drag")

    @property
    def observation_space(self):
        return JBox.create(4)

    @property
    def action_space(self):
        return JBox.create(2, low=-2.0, high=2.0)

    def step(self, states, actions, params=None, key=None):
        m = self.resolve_param(params, "mass", self.mass)
        drag = self.resolve_param(params, "drag", self.drag)
        vel = states[..., 2:] + self.dt * (actions / m - drag * states[..., 2:])
        return jnp.concatenate([states[..., :2] + self.dt * vel, vel], axis=-1)


@dataclasses.dataclass(frozen=True)
class PointMass(DynamicsModel):
    mass: float = 1.0
    drag: float = 0.1
    uncertain_params: Tuple[str, ...] = ("mass", "drag")

    @property
    def observation_space(self):
        return Box.create(4)

    @property
    def action_space(self):
        return Box.create(2, low=-2.0, high=2.0)

    def step(self, states, actions, params=None):
        m = self.resolve_param(params, "mass", self.mass)
        drag = self.resolve_param(params, "drag", self.drag)
        vel = states[..., 2:] + self.dt * (actions / m - drag * states[..., 2:])
        return torch.cat([states[..., :2] + self.dt * vel, vel], dim=-1)


def point_mass_costs(xp):
    """``(inst_cost, term_cost)`` on the array module ``xp`` (jnp or torch)."""
    def inst(states, actions=None, **_):
        d = states[..., :2] - xp.asarray(TARGET, dtype=xp.float32)
        c = (d * d).sum(-1)
        if actions is not None:
            c = c + 0.01 * (actions * actions).sum(-1)
        return c

    def term(states, **_):
        d = states[..., :2] - xp.asarray(TARGET, dtype=xp.float32)
        return 10.0 * (d * d).sum(-1)

    return inst, term


# -- utils/math ---------------------------------------------------------------

@pytest.mark.parametrize("event,var", [((2,), 0.5), ((3, 2), "per_dim")])
def test_gmm_log_prob_and_exact_grad_match_jax(rng, event, var):
    means = rng.standard_normal((4,) + event).astype(np.float32)
    x = rng.standard_normal((6,) + event).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    p = int(np.prod(event))
    v = (rng.uniform(0.3, 1.5, p).astype(np.float32) if var == "per_dim"
         else np.float32(var))
    lp_j = jm.gmm_log_prob(jnp.asarray(x), jnp.asarray(means), jnp.asarray(v), jnp.asarray(w))
    lp_t = tm.gmm_log_prob(_t(x), _t(means), _t(v), _t(w))
    np.testing.assert_allclose(lp_t.numpy(), _n(lp_j), rtol=1e-4, atol=1e-5)
    g_j = jm.exact_grad_gmm_log_p(jnp.asarray(x), jnp.asarray(means), jnp.asarray(v),
                                  jnp.asarray(w))
    g_t = tm.exact_grad_gmm_log_p(_t(x), _t(means), _t(v), _t(w))
    assert g_t.shape == x.shape
    np.testing.assert_allclose(g_t.numpy(), _n(g_j), rtol=1e-4, atol=1e-5)


def test_gmm_log_prob_matches_naive_oracle(rng):
    """``tests/test_math.py``'s fp64 oracle at equal weights."""
    means = rng.standard_normal((4, 2)).astype(np.float32)
    samples = rng.standard_normal((6, 2)).astype(np.float32)
    comp = np.stack([-0.5 * ((samples - means[k]) ** 2).sum(-1) / 0.5
                     - np.log(2 * np.pi * 0.5) for k in range(4)], axis=1)
    want = np.log(np.exp(comp).mean(axis=1))
    got = tm.gmm_log_prob(_t(samples), _t(means), 0.5, torch.ones(4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lower", [True, False])
def test_cholesky_psd_matches_jax(rng, lower):
    a = rng.standard_normal((5, 5)).astype(np.float32)
    m = (a @ a.T).astype(np.float32)
    c_j = jm.cholesky_psd(jnp.asarray(m), lower=lower)
    c_t = tm.cholesky_psd(_t(m), lower=lower)
    np.testing.assert_allclose(c_t.numpy(), _n(c_j), rtol=1e-4, atol=1e-5)


# -- utils/distributions ----------------------------------------------------

GAUSS = {
    "full": (np.array([1.0, -1.0], np.float32),
             np.array([[0.5, 0.1], [0.1, 0.3]], np.float32)),
    "diag": (np.array([1.0, -1.0], np.float32), np.array([0.5, 0.3], np.float32)),
}


@pytest.mark.parametrize("kind", ["full", "diag"])
def test_gaussian_sample_from_given_draws_and_log_prob_match_jax(rng, kind):
    mean, cov = GAUSS[kind]
    jd = jdu.Gaussian(jnp.asarray(mean), jnp.asarray(cov))
    td = du.Gaussian(_t(mean), _t(cov))
    key = jax.random.PRNGKey(3)
    x_j = jdu.sample(jd, key, (7, 3))
    eps = jax.random.normal(key, (7, 3, 2), jnp.float32)  # sample's own draw
    x_t = du.sample(td, (7, 3), eps=_t(eps))
    np.testing.assert_allclose(x_t.numpy(), _n(x_j), rtol=1e-5, atol=1e-6)
    pts = rng.standard_normal((5, 2)).astype(np.float32)
    np.testing.assert_allclose(du.log_prob(td, _t(pts)).numpy(),
                               _n(jdu.log_prob(jd, jnp.asarray(pts))), rtol=1e-4)
    for a, b in zip(du.moments(td), jdu.moments(jd)):
        np.testing.assert_allclose(a.numpy(), _n(b), rtol=1e-6)
    assert td.dim == 2


def test_gaussian_generator_draws_have_its_moments():
    """``tests/test_utils.py``'s checks on the port's own draws."""
    mean, cov = GAUSS["full"]
    td = du.Gaussian(_t(mean), _t(cov))
    x = du.sample(td, (5000,), torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(x.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.05)
    from scipy.stats import multivariate_normal

    want = multivariate_normal(mean, cov).logpdf(mean)
    np.testing.assert_allclose(float(du.log_prob(td, _t(mean)[None])[0]), want, rtol=1e-4)


def test_gmm_sample_from_given_draws_is_jax_bit_for_bit(rng):
    means = rng.standard_normal((6, 5)).astype(np.float32)
    var = rng.uniform(0.2, 1.0, 5).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 6).astype(np.float32)
    jd = jdu.ParticleGMM(jnp.asarray(means), jnp.asarray(var), jnp.asarray(w))
    td = du.ParticleGMM(_t(means), _t(var), _t(w))
    key = jax.random.PRNGKey(5)
    x_j = jdu.sample(jd, key, (9,))
    key_c, key_n = jax.random.split(key)  # distributions.py's schedule
    comps = jax.random.categorical(key_c, jnp.log(jnp.asarray(w)), shape=(9,))
    eps = jax.random.normal(key_n, (9, 5), jnp.float32)
    x_t = du.sample(td, (9,), eps=_t(eps), comps=_t(comps))
    np.testing.assert_array_equal(x_t.numpy(), _n(x_j))
    pts = rng.standard_normal((2, 3, 5)).astype(np.float32)
    np.testing.assert_allclose(du.log_prob(td, _t(pts)).numpy(),
                               _n(jdu.log_prob(jd, jnp.asarray(pts))), rtol=1e-4)
    for a, b in zip(du.moments(td), jdu.moments(jd)):
        np.testing.assert_allclose(a.numpy(), _n(b), rtol=1e-5, atol=1e-6)


def test_gmm_generator_draws_keep_components_and_noise_apart():
    """``tests/test_harness.py::test_gmm_sample_keys_independent`` and
    ``tests/test_utils.py::test_gmm_distribution_moments`` on the port's
    draws."""
    gmm = du.ParticleGMM(torch.tensor([[0.0], [100.0]]), torch.tensor(1.0),
                         torch.tensor([1.0, 1.0]))
    x = du.sample(gmm, (5000,), torch.Generator().manual_seed(0)).numpy()
    near0, nearc = x[np.abs(x[:, 0]) < 50], x[np.abs(x[:, 0] - 100) < 50]
    assert 0.8 < near0.std() < 1.2 and 0.8 < (nearc - 100).std() < 1.2
    gmm2 = du.ParticleGMM(torch.tensor([[0.0, 0.0], [2.0, 2.0]]), torch.tensor(0.1),
                          torch.tensor([1.0, 1.0]))
    mean, _cov = du.moments(gmm2)
    np.testing.assert_allclose(mean.numpy(), [1.0, 1.0])
    x2 = du.sample(gmm2, (4000,), torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_allclose(x2.mean(0), [1.0, 1.0], atol=0.1)


def test_sample_rejection_from_given_draws_matches_jax():
    rounds = 6
    jd = jdu.Gaussian(jnp.asarray([0.0]), jnp.asarray([4.0]))
    td = du.Gaussian(torch.tensor([0.0]), torch.tensor([4.0]))
    key = jax.random.PRNGKey(0)
    x_j = jdu.sample_rejection(jd, key, (300,), low=0.5, high=2.0, max_rounds=rounds)
    key, k0 = jax.random.split(key)  # sample_rejection's schedule
    keys = [k0] + list(jax.random.split(key, rounds))
    eps = np.stack([_n(jax.random.normal(k, (300, 1), jnp.float32)) for k in keys])
    x_t = du.sample_rejection(td, (300,), low=0.5, high=2.0, max_rounds=rounds,
                              eps=_t(eps))
    np.testing.assert_allclose(x_t.numpy(), _n(x_j), rtol=1e-5, atol=1e-6)
    inside = du.in_bounds(_t(eps[0]) * 2.0, 0.5, 2.0)
    assert inside.shape == (300, 1) and 0 < int(inside.sum()) < 300


def test_sample_rejection_generator_draws_respect_bounds():
    """``tests/test_utils.py::test_rejection_sampling_respects_bounds``."""
    td = du.Gaussian(torch.tensor([0.0]), torch.tensor([4.0]))
    x = du.sample_rejection(td, (2000,), low=0.5, high=2.0,
                            generator=torch.Generator().manual_seed(0))
    assert float(x.min()) >= 0.5 and float(x.max()) <= 2.0
    assert float(x.mean()) < 1.4


def test_draws_without_a_generator_raise():
    td = du.Gaussian(torch.zeros(2), torch.ones(2))
    gmm = du.ParticleGMM(torch.zeros(3, 2), torch.tensor(1.0), torch.ones(3))
    for fn in (lambda: du.sample(td, (4,)),
               lambda: du.sample(gmm, (4,), eps=torch.zeros(4, 2)),
               lambda: du.sample(gmm, (4,), comps=torch.zeros(4, dtype=torch.long)),
               lambda: Box.create(2, low=-1.0, high=1.0).sample((3,))):
        with pytest.raises(ValueError, match="Generator"):
            fn()
    with pytest.raises(ValueError, match="shape"):
        du.sample(td, (4,), eps=torch.zeros(3, 2))


# -- utils/spaces -------------------------------------------------------------

def test_box_shape_and_sample_match_jax():
    jbox = JBox.create(3, low=-1.0, high=[1.0, 2.0, 3.0])
    box = Box.create(3, low=-1.0, high=[1.0, 2.0, 3.0])
    assert box.shape == jbox.shape == (3,)
    key = jax.random.PRNGKey(0)
    x_j = jbox.sample(key, (100,))
    u = jax.random.uniform(key, (100, 3), jnp.float32)  # Box.sample's own draw
    x_t = box.sample((100,), draws=_t(u))
    np.testing.assert_allclose(x_t.numpy(), _n(x_j), rtol=1e-5, atol=1e-6)
    free_j, free = JBox.create(2), Box.create(2)
    z = jax.random.normal(key, (5, 2), jnp.float32)
    np.testing.assert_array_equal(free.sample((5,), draws=_t(z)).numpy(),
                                  _n(free_j.sample(key, (5,))))
    # tests/test_utils.py::test_box_space on the port's own draws
    x = box.sample((100,), torch.Generator().manual_seed(0))
    assert x.shape == (100, 3) and float(x.min()) >= -1.0
    assert float(x[:, 0].max()) <= 1.0 and float(x[:, 2].max()) > 2.0
    assert free.sample((4,), torch.Generator().manual_seed(0)).shape == (4, 2)


# -- models/base --------------------------------------------------------------

def test_uncertain_params_plumbing_matches_jax():
    jmodel, model = JPointMass(dt=0.1), PointMass(dt=0.1)
    assert model.uncertain_params == jmodel.uncertain_params == ("mass", "drag")
    assert DynamicsModel().uncertain_params == JDynamicsModel().uncertain_params == ()
    mat = np.array([[1.0, 0.1], [2.5, 0.3], [0.7, 0.0]], np.float32)
    pd_j, pd_t = jmodel.params_to_dict(jnp.asarray(mat)), model.params_to_dict(_t(mat))
    assert list(pd_t) == list(pd_j)
    for k in pd_j:
        assert pd_t[k].shape == pd_j[k].shape == (3, 1)
        np.testing.assert_array_equal(pd_t[k].numpy(), _n(pd_j[k]))
    np.testing.assert_array_equal(model.dict_to_params(pd_t).numpy(),
                                  _n(jmodel.dict_to_params(pd_j)))
    one = model.params_to_dict(_t(mat[0]))  # a single sample is a [1, p] matrix
    assert one["mass"].shape == (1, 1)
    assert model.resolve_param(None, "mass", 1.0) == 1.0
    assert model.resolve_param({"drag": one["drag"]}, "mass", 1.0) == 1.0
    assert model.resolve_param(one, "mass", 1.0) is one["mass"]


def test_rollout_with_params_axis_matches_jax(rng):
    """``tests/test_models.py::test_rollout_with_params_axis`` on the point
    mass: a [P, n, H, a] action batch under P parameter samples."""
    jmodel, model = JPointMass(dt=0.1), PointMass(dt=0.1)
    acts = rng.uniform(-2, 2, (2, 4, 5, 2)).astype(np.float32)
    mat = np.array([[1.0, 0.1], [3.0, 0.5]], np.float32)
    s0 = np.array([0.2, -0.1, 0.0, 0.3], np.float32)
    pj = {k: v.reshape(2, 1, 1) for k, v in jmodel.params_to_dict(jnp.asarray(mat)).items()}
    pt = {k: v.reshape(2, 1, 1) for k, v in model.params_to_dict(_t(mat)).items()}
    tr_j = jrollout(jmodel, jnp.asarray(s0), jnp.asarray(acts), pj)
    tr_t = rollout(model, _t(s0), _t(acts), pt)
    assert tr_t.shape == (2, 4, 6, 4)
    np.testing.assert_allclose(tr_t.numpy(), _n(tr_j), rtol=1e-5, atol=1e-6)
    assert not np.allclose(tr_t[0].numpy(), tr_t[1].numpy())


# -- inference/svgd: gradient_mask, Adagrad, roll_opt_state --------------------

def _run_both(x0, steps, **kw):
    """``steps`` SVGD steps on the score ``-x`` in both packages."""
    jmask, tmask = kw.pop("mask", (None, None))
    jopt, topt = kw.pop("optimizer", (None, None))
    js = JSVGD(kernel=JGaussianKernel(), optimizer=jopt, gradient_mask=jmask, **kw)
    ts = SVGD(kernel=GaussianKernel(), optimizer=topt, gradient_mask=tmask, **kw)
    xj, stj, _ = js.run(jnp.asarray(x0), lambda x, k: JScoreResult(grad_log_p=-x), steps)
    xt, stt, _ = ts.run(_t(x0), lambda x, g: ScoreResult(grad_log_p=-x), steps)
    return (xj, stj), (xt, stt)


@pytest.mark.parametrize("adagrad", [False, True])
def test_raw_and_adagrad_updates_match_jax(adagrad):
    x0 = (np.random.default_rng(4).standard_normal((30, 2)) + 2.0).astype(np.float32)
    lr = 0.5 if adagrad else 0.1
    (xj, stj), (xt, stt) = _run_both(x0, 20, lr=lr, adagrad=adagrad)
    np.testing.assert_allclose(xt.numpy(), _n(xj), rtol=1e-4, atol=1e-5)
    if adagrad:
        np.testing.assert_allclose(stt.opt_state.numpy(), _n(stj.opt_state),
                                   rtol=1e-4, atol=1e-5)
    else:
        assert stt.opt_state == () and stj.opt_state == ()
    # tests/test_svgd.py::test_raw_lr_and_adagrad_paths on the port's run
    ts = SVGD(kernel=GaussianKernel(), lr=lr, adagrad=adagrad)
    xf, _, _ = ts.run(_t(x0), lambda x, g: ScoreResult(grad_log_p=-x), 200)
    assert float(xf.mean(0).abs().max()) < 0.8


def test_gradient_mask_freezes_particles_as_jax():
    mask = np.ones((10, 2), np.float32)
    mask[:3] = 0.0
    x0 = (np.random.default_rng(6).standard_normal((10, 2)) + 1.0).astype(np.float32)
    (xj, _), (xt, _) = _run_both(x0, 20, lr=0.2, mask=(jnp.asarray(mask), _t(mask)))
    np.testing.assert_allclose(xt.numpy(), _n(xj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt[:3].numpy(), x0[:3], atol=1e-6)
    assert float(xt[3:].abs().mean()) < float(np.abs(x0[3:]).mean())


def test_roll_opt_state_matches_jax(rng):
    shape = (4, 5, 3)
    x0 = rng.standard_normal(shape).astype(np.float32)
    (xj, stj), (xt, stt) = _run_both(x0, 3, optimizer=(optax.adam(0.1), Adam(0.1)))
    rj = j_roll_opt_state(stj.opt_state, shape)[0]
    rt = roll_opt_state(stt.opt_state, shape)
    assert int(rt.count) == int(rj.count) == 3
    for name in ("mu", "nu"):
        got, before = getattr(rt, name), getattr(stt.opt_state, name)
        np.testing.assert_allclose(got.numpy(), _n(getattr(rj, name)), rtol=1e-4, atol=1e-5)
        assert not got[:, -1].any()
        np.testing.assert_array_equal(got[:, :-1].numpy(), before[:, 1:].numpy())
    acc = torch.arange(60, dtype=torch.float32).reshape(shape)  # Adagrad's leaf
    row = acc[0]
    got = roll_opt_state((acc, torch.tensor(2), [row]), shape)
    np.testing.assert_array_equal(got[0].numpy(),
                                  _n(j_roll_opt_state(jnp.asarray(acc.numpy()), shape)))
    assert int(got[1]) == 2 and got[2][0] is row
