"""The port's DISCO, its unscented transform, the pendulum, cartpole and
skid-steer models and the pendulum runners against the JAX package.

* Each model's ``step`` (with parameter dicts broadcast over a parameter
  axis) and costs against JAX's under ``jit`` at rtol 1e-6 (atol 1e-6 where
  a state passes near 0); ``rollout`` over a parameter axis; the spaces.
* ``MerweScaledUTF``: weights bit for bit, sigma points rtol 1e-6, the
  inverse transform's mean rtol 1e-5 and covariance rtol 1e-4, the moments
  recovered at bounded weights (``tests/test_utils.py``).
* ``DISCO.forward`` against JAX's with JAX's draws handed over
  (``DISCODraws``: ``key_eps, key_par = split(key)``; the perturbations
  ``normal(key_eps, (n_actions, n_pol, H, a))``, the parameter samples from
  ``key_par`` as ``du.sample`` draws them): Monte-Carlo rollouts with none,
  full-covariance, diagonal, log-space and mixture (``ParticleGMM``)
  parameter samples, sigma-point rollouts, ``n_pol = 2`` and the
  control-cost term (``ctrl_penalty < 1``). Costs rtol 1e-5, omega rtol
  1e-4 / atol 1e-7, the sampled actions, the plans and ``a_mix`` rtol 1e-4
  / atol 1e-5, the oracle tests' tolerances (``tests/test_disco_oracle.py``),
  over two chained solves, and each ``act`` strategy's action and roll.
* Both ``test_disco_oracle.py`` updates against its numpy oracle on the
  port, and ``act``'s strategies: ``average``, ``argmax``, ``best_sample``
  (the argmax of omega normalised per policy, as JAX; ROADMAP.md queue 3),
  ``external``, the clip and the zero-filled roll.
* ``test_controllers.py``'s closed loops on the port, from a seeded
  generator: DISCO drives the point mass to the goal and balances the
  cartpole. ``run_dust``/``run_disco`` and ``main`` run on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.controllers import DISCO as JDISCO
from sigsvgd_tpu.models import CartPoleModel as JCartPole
from sigsvgd_tpu.models import ParticleModel as JParticle
from sigsvgd_tpu.models import PendulumModel as JPendulum
from sigsvgd_tpu.models import SkidSteerModel as JSkidSteer
from sigsvgd_tpu.models import rollout as jrollout
from sigsvgd_tpu.utils import distributions as jdu
from sigsvgd_tpu.utils.utf import MerweScaledUTF as JUTF
from sigsvgd_tpu_torch.controllers.disco import DISCO, DISCODraws, DISCOState
from sigsvgd_tpu_torch.experiments import pendulum
from sigsvgd_tpu_torch.models.cartpole import CartPoleModel
from sigsvgd_tpu_torch.models.particle import ParticleModel
from sigsvgd_tpu_torch.models.pendulum import PendulumModel
from sigsvgd_tpu_torch.models.rollout import rollout
from sigsvgd_tpu_torch.models.skid_steer import SkidSteerModel
from sigsvgd_tpu_torch.utils import distributions as du
from sigsvgd_tpu_torch.utils.utf import MerweScaledUTF


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


MODELS = {
    "pendulum": (JPendulum(dt=0.05), PendulumModel(dt=0.05), 2, 1,
                 ("swingup_inst_cost", "swingup_term_cost"),
                 [[9.8, 1.0, 1.0], [5.0, 2.0, 0.5], [12.0, 0.7, 1.3]]),
    "cartpole": (JCartPole(dt=0.02), CartPoleModel(dt=0.02), 4, 1,
                 ("balance_inst_cost", "balance_term_cost"),
                 [[9.8, 1.0, 0.1, 1.0, 5e-4, 2e-6, 10.0],
                  [9.0, 1.5, 0.2, 0.8, 1e-3, 1e-5, 8.0],
                  [10.0, 0.8, 0.05, 1.2, 0.0, 0.0, 12.0]]),
    "cartpole_ref_mass": (JCartPole(dt=0.02, reference_mass_bug=True),
                          CartPoleModel(dt=0.02, reference_mass_bug=True), 4, 1,
                          ("balance_inst_cost", "balance_term_cost"),
                          [[9.8, 1.0, 0.1, 1.0, 5e-4, 2e-6, 10.0]] * 3),
    "skid_steer": (JSkidSteer(dt=0.1), SkidSteerModel(dt=0.1), 5, 2, (),
                   [[0.2, 0.0625, 0.475], [0.1, 0.07, 0.5], [0.3, 0.05, 0.4]]),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_step_and_costs_match_jax(name):
    jm, tm, ds, da, costs, params = MODELS[name]
    rng = np.random.default_rng(0)
    s = rng.uniform(-1.5, 1.5, (3, 16, ds)).astype(np.float32)
    s[0, 0] = 0.0  # sign(0) and zero velocities
    a = rng.uniform(-3, 3, (3, 16, da)).astype(np.float32)
    p = np.asarray(params, np.float32)
    step_j = jax.jit(lambda s, a, p: (jm.step(s, a), jm.step(
        s, a, {k: v.reshape(3, 1, 1) for k, v in jm.params_to_dict(p).items()})))
    want, want_p = step_j(s, a, p)
    got = tm.step(_t(s), _t(a))
    got_p = tm.step(_t(s), _t(a), {k: v.reshape(3, 1, 1)
                                   for k, v in tm.params_to_dict(_t(p)).items()})
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.array(want_p), rtol=1e-6, atol=1e-6)
    assert not np.allclose(got_p[0].numpy(), got_p[1].numpy())
    for c in costs:
        fj, ft = getattr(jm, c), getattr(tm, c)
        if "inst" in c:
            np.testing.assert_allclose(ft(_t(s), _t(a)).numpy(),
                                       np.array(jax.jit(fj)(s, a)), rtol=1e-6)
        np.testing.assert_allclose(ft(_t(s)).numpy(), np.array(jax.jit(fj)(s)), rtol=1e-6)
    for sp in ("observation_space", "action_space"):
        js, ts = getattr(jm, sp), getattr(tm, sp)
        assert (ts.dim, ts.low_t, ts.high_t) == (js.dim, js.low_t, js.high_t)
    assert tm.uncertain_params == jm.uncertain_params
    np.testing.assert_array_equal(tm.dict_to_params(tm.params_to_dict(_t(p))).numpy(), p)
    if name == "pendulum":
        np.testing.assert_allclose(tm.get_obs(_t(s)).numpy(), np.array(jm.get_obs(s)),
                                   rtol=1e-6, atol=1e-7)


def test_rollout_with_params_axis_matches_jax():
    jm, tm = JPendulum(dt=0.05), PendulumModel(dt=0.05)
    acts = np.random.default_rng(1).normal(0, 1, (2, 4, 5, 1)).astype(np.float32)
    p = np.asarray([[9.8, 1.0, 1.0], [3.0, 1.5, 0.7]], np.float32)
    jp = {k: v.reshape(2, 1, 1) for k, v in jm.params_to_dict(p).items()}
    tp = {k: v.reshape(2, 1, 1) for k, v in tm.params_to_dict(_t(p)).items()}
    want = jax.jit(lambda a: jrollout(jm, jnp.asarray([0.1, 0.0]), a, jp))(acts)
    got = rollout(tm, torch.tensor([0.1, 0.0]), _t(acts), tp)
    assert got.shape == (2, 4, 6, 2)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,alpha,kappa", [(3, 1.0, 0.0), (2, 0.5, 1.0), (1, 1e-3, 0.0)])
def test_utf_matches_jax(n, alpha, kappa):
    ju, tu = JUTF(n=n, alpha=alpha, kappa=kappa), MerweScaledUTF(n=n, alpha=alpha, kappa=kappa)
    assert tu.pts == ju.pts
    np.testing.assert_array_equal(tu.loc_weights.numpy(), np.array(ju.loc_weights))
    np.testing.assert_array_equal(tu.cov_weights.numpy(), np.array(ju.cov_weights))
    rng = np.random.default_rng(n)
    mean = rng.normal(0, 1, n).astype(np.float32)
    a = rng.standard_normal((n, n)).astype(np.float32)
    cov = (a @ a.T + np.eye(n, dtype=np.float32)).astype(np.float32)
    sj = jax.jit(ju.compute_sigma_points)(mean, cov)
    st = tu.compute_sigma_points(_t(mean), _t(cov))
    np.testing.assert_allclose(st.numpy(), np.array(sj), rtol=1e-6, atol=1e-6)
    mj, cj = jax.jit(ju.unscented_transform)(sj)
    mt, ct = tu.unscented_transform(st)
    np.testing.assert_allclose(mt.numpy(), np.array(mj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.array(cj), rtol=1e-4, atol=1e-4)
    if alpha == 1.0:  # bounded weights: the moments come back
        np.testing.assert_allclose(mt.numpy(), mean, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ct.numpy(), cov, rtol=1e-4, atol=1e-4)


def _point_mass(jax_side: bool, **kw):
    kw = dict(dict(dt=0.1, control_type="acceleration", max_speed=5.0, map_size=(8, 8),
                   map_cell_size=0.1, init_state=(-2.0, -2.0, 0.0, 0.0),
                   cost_params={"w_qpos": 2.0, "w_qvel": 0.2, "w_ctrl": 0.01,
                                "w_qpos_T": 10.0, "w_qvel_T": 0.5, "w_obs": 0.0}), **kw)
    return JParticle.create(**kw) if jax_side else ParticleModel.create(device="cpu", **kw)


def _dist(kind: str, jax_side: bool):
    xp = jnp if jax_side else torch
    mod = jdu if jax_side else du
    arr = (lambda a: jnp.asarray(a, jnp.float32)) if jax_side else (
        lambda a: torch.tensor(a, dtype=torch.float32))
    if kind == "full":
        return mod.Gaussian(mean=arr([9.8, 1.0, 1.0]),
                            cov=arr([[0.05, 0.01, 0.0], [0.01, 0.04, 0.0], [0.0, 0.0, 0.02]]))
    if kind == "diag_log":
        return mod.Gaussian(mean=arr(np.log([9.8, 1.0, 1.0])), cov=arr([0.01, 0.02, 0.005]))
    if kind == "gmm":
        means = arr(np.random.default_rng(4).normal([9.8, 1.0, 1.0], 0.2, (5, 3)))
        return mod.ParticleGMM(means=means, var=arr(0.01), weights=xp.ones(5))
    return None


DISCO_CASES = {
    # (model, dist, DISCO kwargs)
    "mc_point_mass": ("point_mass", None, dict(n_actions=32, pol_cov=((4.0, 0.5), (0.5, 2.0)),
                                               temperature=0.5, ctrl_penalty=0.9)),
    "params_full": ("pendulum", "full", dict(n_actions=24, n_params=4, temperature=0.3,
                                            pol_cov=((9.0,),))),
    "params_diag_log": ("pendulum", "diag_log", dict(n_actions=24, n_params=3,
                                                    params_log_space=True, n_pol=2)),
    "params_gmm": ("pendulum", "gmm", dict(n_actions=16, n_params=4, n_pol=3,
                                          ctrl_penalty=0.5)),
    "utf": ("pendulum", "full", dict(n_actions=24, utf=3, n_pol=2)),
    "utf_gmm": ("pendulum", "gmm", dict(n_actions=16, utf=3)),
}
H = 10


def _disco_pair(case):
    model, dist, kw = DISCO_CASES[case]
    kw = dict(kw)
    utf = kw.pop("utf", None)
    if model == "point_mass":
        jm, tm = _point_mass(True), _point_mass(False)
        costs = ("default_inst_cost", "default_term_cost")
    else:
        jm, tm = JPendulum(dt=0.05), PendulumModel(dt=0.05)
        costs = ("swingup_inst_cost", "swingup_term_cost")
    jc = JDISCO(model=jm, hz_len=H, utf=utf and JUTF(n=utf),
                inst_cost_fn=getattr(jm, costs[0]), term_cost_fn=getattr(jm, costs[1]), **kw)
    tc = DISCO(model=tm, hz_len=H, device="cpu", utf=utf and MerweScaledUTF(n=utf),
               inst_cost_fn=getattr(tm, costs[0]), term_cost_fn=getattr(tm, costs[1]), **kw)
    return jc, tc, _dist(dist, True), _dist(dist, False)


def jax_disco_draws(ctrl: JDISCO, params_dist, key) -> DISCODraws:
    """Every draw JAX's ``DISCO.forward`` makes from ``key``."""
    key_eps, key_par = jax.random.split(key)
    eps = _t(jax.random.normal(key_eps, (ctrl.n_actions, ctrl.n_pol, ctrl.hz_len,
                                         ctrl.dim_a)))
    params = comps = None
    if ctrl.n_params > 0 and params_dist is not None and ctrl.utf is None:
        if isinstance(params_dist, jdu.ParticleGMM):
            key_c, key_n = jax.random.split(key_par)
            comps = _t(jax.random.categorical(key_c, jnp.log(params_dist.weights),
                                              shape=(ctrl.n_params,)))
            params = _t(jax.random.normal(key_n, (ctrl.n_params, params_dist.means.shape[-1])))
        else:
            params = _t(jax.random.normal(key_par, (ctrl.n_params,)
                                          + params_dist.mean.shape))
    return DISCODraws(eps=eps, params=params, params_comps=comps)


@pytest.mark.parametrize("case", list(DISCO_CASES))
def test_forward_matches_jax(case):
    jc, tc, jdist, tdist = _disco_pair(case)
    rng = np.random.default_rng(2)
    pol0 = rng.normal(0, 0.5, (jc.n_pol, H, jc.dim_a)).astype(np.float32)
    js, ts = jc.init(jnp.asarray(pol0)), tc.init(_t(pol0))
    state = (np.array([-2.0, -2.0, 0.3, 0.1], np.float32) if jc.dim_a == 2
             else np.array([np.pi - 0.3, 0.5], np.float32))
    fwd = jax.jit(lambda s, c, k: jc.forward(s, c, jdist, k))
    for solve in range(2):
        key = jax.random.PRNGKey(10 + solve)
        js2, dj = fwd(jnp.asarray(state), js, key)
        ts2, dt_ = tc.forward(_t(state), ts, tdist, draws=jax_disco_draws(jc, jdist, key))
        np.testing.assert_allclose(dt_.costs.numpy(), np.array(dj.costs), rtol=1e-5)
        np.testing.assert_allclose(dt_.omega.numpy(), np.array(dj.omega), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(dt_.actions.numpy(), np.array(dj.actions), rtol=1e-4,
                                   atol=1e-5)
        assert dt_.states.shape == dj.states.shape
        np.testing.assert_allclose(ts2.a_mat.numpy(), np.array(js2.a_mat), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts2.a_mix.numpy(), np.array(js2.a_mix), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts2.a_seq.numpy(), np.array(js2.a_seq), rtol=1e-4, atol=1e-5)
        for strategy in ("average", "argmax", "best_sample"):
            aj, jr = jc.act(js2, strategy=strategy, data=dj)
            at, tr = tc.act(ts2, strategy=strategy, data=dt_)
            np.testing.assert_allclose(at.numpy(), np.array(aj), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(tr.a_mat.numpy(), np.array(jr.a_mat), rtol=1e-4,
                                       atol=1e-5)
        js, ts = jr, tr
        state = np.array(jc.model.step(jnp.asarray(state)[None], aj)[0])


def _oracle_model(jax_side):
    kw = dict(dt=0.1, control_type="velocity", map_size=(10, 10), map_cell_size=0.5,
              target_state=(1.0, -0.5))
    return JParticle.create(**kw) if jax_side else ParticleModel.create(device="cpu", **kw)


def test_single_policy_update_matches_numpy_oracle():
    """``tests/test_disco_oracle.py::test_disco_matches_numpy_oracle`` on the
    port, with JAX's perturbations of that test."""
    dt, na, temp, goal = 0.1, 16, 0.7, np.array([1.0, -0.5])

    def inst_cost(states, actions=None, **_):
        c = torch.sum((states - torch.tensor(goal, dtype=torch.float32)) ** 2, -1)
        if actions is not None:
            c = c + 0.05 * torch.sum(actions**2, -1)
        return c

    def term_cost(states, **_):
        return 5.0 * torch.sum((states - torch.tensor(goal, dtype=torch.float32)) ** 2, -1)

    ctrl = DISCO(model=_oracle_model(False), hz_len=4, n_actions=na, device="cpu",
                 temperature=temp, ctrl_penalty=1.0, inst_cost_fn=inst_cost,
                 term_cost_fn=term_cost)
    key_eps, _ = jax.random.split(jax.random.PRNGKey(5))
    eps = np.asarray(jax.random.normal(key_eps, (na, 1, 4, 2)))
    new_state, data = ctrl.forward(torch.zeros(2), ctrl.init(torch.ones(4, 2) * 0.3),
                                   draws=DISCODraws(eps=_t(eps)))
    actions = 0.3 + eps[:, 0]
    s, costs = np.zeros((na, 2)), np.zeros(na)
    for t in range(4):
        costs += ((s - goal) ** 2).sum(-1) + 0.05 * (actions[:, t] ** 2).sum(-1)
        s = s + actions[:, t] * dt
    costs += 5.0 * ((s - goal) ** 2).sum(-1)
    shifted = -(costs - costs.min()) / temp
    omega = np.exp(shifted) / np.exp(shifted).sum()
    plan = 0.3 + np.einsum("n,nha->ha", omega, eps[:, 0])
    np.testing.assert_allclose(data.costs[:, 0].numpy(), costs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(data.omega[:, 0].numpy(), omega, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(new_state.a_seq.numpy(), plan, rtol=1e-4, atol=1e-5)


def test_two_policy_ensemble_matches_numpy_oracle():
    """``test_disco_two_policy_ensemble_matches_numpy_oracle`` on the port:
    the shared baseline, per-policy softmax, ``a_mix`` from the
    log-normalizers, both mixing strategies and the roll."""
    dt, na, temp, goal = 0.1, 16, 0.7, np.array([1.0, -0.5])

    def inst_cost(states, actions=None, **_):
        return torch.sum((states - torch.tensor(goal, dtype=torch.float32)) ** 2, -1)

    model = _oracle_model(False)
    ctrl = DISCO(model=model, hz_len=4, n_actions=na, n_pol=2, device="cpu",
                 temperature=temp, ctrl_penalty=1.0, inst_cost_fn=inst_cost)
    pol0 = np.stack([np.full((4, 2), 0.3), np.full((4, 2), -0.2)]).astype(np.float32)
    key_eps, _ = jax.random.split(jax.random.PRNGKey(9))
    eps = np.asarray(jax.random.normal(key_eps, (na, 2, 4, 2)))
    new_state, data = ctrl.forward(torch.zeros(2), ctrl.init(_t(pol0)),
                                   draws=DISCODraws(eps=_t(eps)))
    actions = pol0[None] + eps
    s, costs = np.zeros((na, 2, 2)), np.zeros((na, 2))
    for t in range(4):
        costs += ((s - goal) ** 2).sum(-1)
        s = s + actions[:, :, t] * dt
    shifted = -(costs - costs.min()) / temp
    eta = np.log(np.exp(shifted).sum(0))
    omega = np.exp(shifted - eta[None])
    a_mat = pol0 + np.einsum("np,npha->pha", omega, eps)
    a_mix = np.exp(eta - np.log(np.exp(eta).sum()))
    np.testing.assert_allclose(data.costs.numpy(), costs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(data.omega.numpy(), omega, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(new_state.a_mat.numpy(), a_mat, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(new_state.a_mix.numpy(), a_mix, rtol=1e-4, atol=1e-5)
    act_argmax, rolled = ctrl.act(new_state, strategy="argmax")
    lo, hi = model.action_space.low.numpy(), model.action_space.high.numpy()
    np.testing.assert_allclose(act_argmax[0].numpy(),
                               np.clip(a_mat[int(np.argmax(a_mix))][0], lo, hi),
                               rtol=1e-4, atol=1e-5)
    act_avg, _ = ctrl.act(new_state, strategy="average")
    np.testing.assert_allclose(act_avg[0].numpy(),
                               np.clip(np.einsum("p,pha->ha", a_mix, a_mat)[0], lo, hi),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rolled.a_mat[:, -1].numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(rolled.a_mat[:, 0].numpy(), a_mat[:, 1], rtol=1e-4, atol=1e-5)
    # best_sample: the argmax of omega normalised per policy, as JAX
    best, _ = ctrl.act(new_state, strategy="best_sample", data=data)
    flat = int(np.argmax(omega.reshape(-1)))
    want = np.clip(actions.reshape(-1, 4, 2)[flat][0], lo, hi)
    np.testing.assert_allclose(best[0].numpy(), want, rtol=1e-5, atol=1e-6)


def test_act_clips_rolls_and_checks_its_strategy():
    """``test_disco_act_clips_and_rolls`` on the port, the ``external``
    strategy and the strategies' errors."""
    model = ParticleModel.create(dt=0.1, control_type="velocity", max_speed=1.0,
                                 map_size=(10, 10), map_cell_size=0.5, device="cpu")
    ctrl = DISCO(model=model, hz_len=3, n_actions=4, device="cpu")
    cstate = ctrl.init(torch.tensor([[5.0, -5.0], [0.5, 0.5], [0.2, -0.2]]))
    assert isinstance(cstate, DISCOState) and cstate.a_mat.shape == (1, 3, 2)
    action, rolled = ctrl.act(cstate)
    np.testing.assert_allclose(action[0].numpy(), [1.0, -1.0])
    np.testing.assert_allclose(rolled.a_seq[-1].numpy(), [0.0, 0.0])
    np.testing.assert_allclose(rolled.a_seq[0].numpy(), [0.5, 0.5])
    ext, _ = ctrl.act(cstate, steps=2, strategy="external",
                      ext_actions=torch.tensor([[0.1, 2.0], [0.3, 0.4], [0.0, 0.0]]))
    np.testing.assert_allclose(ext.numpy(), [[0.1, 1.0], [0.3, 0.4]])
    for kw, msg in ((dict(strategy="best_sample"), "data"),
                    (dict(strategy="external"), "ext_actions"), (dict(strategy="x"), "Invalid")):
        with pytest.raises(ValueError, match=msg):
            ctrl.act(cstate, **kw)
    with pytest.raises(ValueError, match="Generator"):
        ctrl.forward(torch.zeros(2), cstate)


def test_disco_drives_point_mass_to_goal():
    """``tests/test_controllers.py::test_disco_drives_point_mass_to_goal``
    on the port, its draws from a seeded generator."""
    model = _point_mass(False)
    ctrl = DISCO(model=model, hz_len=15, n_actions=128, device="cpu",
                 pol_cov=tuple(map(tuple, (np.eye(2) * 4.0).tolist())), temperature=0.5,
                 ctrl_penalty=0.99, inst_cost_fn=model.default_inst_cost,
                 term_cost_fn=model.default_term_cost)
    cstate, state = ctrl.init(), torch.tensor(model.init_state)
    gen = torch.Generator().manual_seed(0)
    for _ in range(60):
        cstate, _ = ctrl.forward(state, cstate, None, gen)
        action, cstate = ctrl.act(cstate)
        state = model.step(state[None], action)[0]
    dist = float(torch.linalg.vector_norm(state[:2]))
    assert dist < 0.5, f"DISCO did not reach goal, dist={dist}"


def test_disco_cartpole_balance():
    """``tests/test_controllers.py::test_disco_cartpole_balance`` on the port."""
    model = CartPoleModel(dt=0.02)
    ctrl = DISCO(model=model, hz_len=25, n_actions=128, device="cpu", pol_cov=((0.4,),),
                 temperature=0.2, ctrl_penalty=1.0, inst_cost_fn=model.balance_inst_cost,
                 term_cost_fn=model.balance_term_cost)
    cstate, state = ctrl.init(), torch.tensor([0.0, 0.0, 0.15, 0.0])
    gen = torch.Generator().manual_seed(0)
    max_theta = 0.0
    for _ in range(120):
        cstate, _ = ctrl.forward(state, cstate, None, gen)
        action, cstate = ctrl.act(cstate)
        state = model.step(state[None], action)[0]
        max_theta = max(max_theta, float(state[2].abs()))
    assert max_theta < 0.25, f"pole fell: max |theta|={max_theta}"


def test_pendulum_runners_run_on_the_cpu(capsys):
    res = pendulum.run_dust(steps=4, horizon=8, opt_steps=2, device="cpu")
    assert res["trajectory"].shape == (5, 2) and res["actions"].shape == (4, 1)
    assert np.isfinite(res["trajectory"]).all()
    again = pendulum.run_dust(steps=4, horizon=8, opt_steps=2, device="cpu")
    np.testing.assert_array_equal(res["trajectory"], again["trajectory"])
    res = pendulum.run_disco(steps=4, horizon=8, n_actions=32, n_pol=2, device="cpu")
    assert res["trajectory"].shape == (5, 2) and np.isfinite(res["trajectory"]).all()
    assert res["final_upright_error_rad"] >= 0.0 and res["solves_per_s"] > 0
    pendulum.main(["--controller", "disco", "--steps", "2", "--device", "cpu"])
    assert '"controller": "disco"' in capsys.readouterr().out
