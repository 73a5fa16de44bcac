"""The port's DuSt with the score-function likelihood and the rest of its
options, against the JAX controller with the same draws.

``jax.random`` and torch draw different numbers: the test takes JAX's own
draws with ``jax.random`` on ``DuSt.forward``'s key schedule
(``key, key_par = split(key)``; ``keys = split(key, opt_steps + 1)``; the
step's action samples ``normal(keys[t], (S,) + pol.shape)``; the parameter
samples from ``key_par``; the resample roll from ``keys[-1]``, split into
its component and noise keys) and hands them to the port's ``forward`` as
``DuStDraws``.

* Signature mode, λ=0: two chained MC solves (``n_action_samples=4``) of
  bench's flagship problem cut to 12 policies and horizon 8, by
  ``tests/test_torch_dust.py``'s ``run_two_chained_solves``, its
  tolerances and keep-mask method: costs rtol 1e-5, K atol 3e-5, grad_k
  scaled 5e-5, φ scaled 1e-4, the weights' argmax, ``a_seq``, the rolled
  policies (atol 2e-5) and Adam's first moment (atol 1e-5).
* Policy mode, on the point mass of ``tests/test_torch_distributions.py``
  (a double integrator with uncertain mass and drag), 4 policies + 2 frozen
  primitives, horizon 6: two chained solves a case (``CASES``) covering a
  non-identity ``pol_cov``, 3 parameter samples from a full-covariance and
  from a diagonal ``Gaussian``, ``params_log_space``, ``params_dist=None``
  falling back to the defaults, the three roll strategies, ``weighted_prior``
  and ``roll_opt_state``. Held: costs rtol 1e-5; the weights' argmax and
  the weights (the next prior's with ``weighted_prior``) rtol 1e-4 (a
  cost error of rtol 1e-5 at these costs, up to ~26 with T = 1, would move
  a log-weight by up to 2.6e-4; the CPU runs measure ≤ 2.3e-6); ``a_seq``
  and the rolled policies atol 2e-5; Adam's moments atol 1e-5; the
  primitives unchanged (atol 1e-6, ``tests/test_controllers.py``); the
  first solve's resampled last step atol 1e-6 (equal inputs and draws; the
  jitted JAX solve may contract ``μ + ε·σ`` into one rounding), and
  ``_roll`` on its own bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigsvgd_tpu.controllers import DuSt as JDuSt
from sigsvgd_tpu.kernels import GaussianKernel as JGaussianKernel
from sigsvgd_tpu.utils import distributions as jdu
from sigsvgd_tpu_torch.controllers.dust import DuSt, DuStDraws
from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
from sigsvgd_tpu_torch.inference.svgd import Adam
from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel
from sigsvgd_tpu_torch.utils import distributions as du
from test_torch_distributions import JPointMass, PointMass, point_mass_costs
from test_torch_dust import run_two_chained_solves

N_POL, N_PRIM, HZ, A, S, P, STEPS = 4, 2, 6, 2, 4, 3, 2
N = N_POL + N_PRIM
X0 = (0.0, 0.0, 0.2, -0.1)


def test_two_chained_mc_signature_solves_match_jax():
    run_two_chained_solves("lambda0", n_pol=12, n_samples=4)


COV = ((0.5, 0.1), (0.1, 0.3))
PARAMS = {
    "full": (np.log([1.5, 0.2]).astype(np.float32),
             np.array([[0.04, 0.01], [0.01, 0.09]], np.float32)),
    "diag": (np.array([1.2, 0.15], np.float32), np.array([0.01, 0.002], np.float32)),
}
CASES = {
    # the score-function likelihood with a policy covariance, parameters
    # sampled in log space from a full-covariance Gaussian, the resample
    # roll, the weights kept as the next prior's, Adam's state rolled
    "mc_cov_full_log_resample": dict(samples=S, pol_cov=COV, params="full",
                                     params_log_space=True, roll="resample",
                                     weighted_prior=True, adam=True,
                                     roll_opt_state=True),
    # diagonal parameter samples, the mean roll, the raw lr update
    "mc_diag_mean": dict(samples=S, params="diag", roll="mean"),
    # the autograd likelihood under parameter samples, the repeat roll
    "autograd_diag_repeat": dict(samples=0, params="diag", roll="repeat", adam=True),
    # samples asked for without a distribution: the defaults
    "mc_params_none": dict(samples=S, params=None, roll="repeat",
                           weighted_prior=True),
}


def _controllers(case):
    inst_j, term_j = point_mass_costs(jnp)
    inst_t, term_t = point_mass_costs(torch)
    common = dict(hz_len=HZ, n_pol=N_POL, n_prim=N_PRIM, kernel_mode="policy",
                  n_action_samples=case["samples"], n_params_samples=P,
                  pol_cov=case.get("pol_cov", ()), lr=0.05,
                  params_log_space=case.get("params_log_space", False),
                  weighted_prior=case.get("weighted_prior", False),
                  roll_strategy=case["roll"],
                  roll_opt_state=case.get("roll_opt_state", False))
    jctrl = JDuSt(model=JPointMass(dt=0.1), kernel=JGaussianKernel(),
                  optimizer=optax.adam(0.05) if case.get("adam") else None,
                  inst_cost_fn=inst_j, term_cost_fn=term_j, **common)
    tctrl = DuSt(model=PointMass(dt=0.1), kernel=GaussianKernel(), device="cpu",
                 optimizer=Adam(0.05) if case.get("adam") else None,
                 inst_cost_fn=inst_t, term_cost_fn=term_t, **common)
    return jctrl, tctrl


def _params_dists(case):
    if case["params"] is None:
        return None, None
    mean, cov = PARAMS[case["params"]]
    return (jdu.Gaussian(jnp.asarray(mean), jnp.asarray(cov)),
            du.Gaussian(torch.from_numpy(mean), torch.from_numpy(cov)))


def jax_forward_draws(key, case, prior_weights) -> DuStDraws:
    """Every draw JAX's ``forward`` makes from ``key`` (see the module
    docstring), as the port's ``DuStDraws``."""
    key, key_par = jax.random.split(key)
    all_keys = jax.random.split(key, STEPS + 1)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    actions = None
    if case["samples"]:
        actions = t(np.stack([np.array(jax.random.normal(k, (S, N, HZ, A), jnp.float32))
                              for k in all_keys[:STEPS]]))
    params = None
    if case["params"] is not None:
        params = t(jax.random.normal(key_par, (P, 2), jnp.float32))
    key_c, key_n = jax.random.split(all_keys[STEPS])
    comps = jax.random.categorical(key_c, jnp.log(prior_weights), shape=(N,))
    noise = jax.random.normal(key_n, (N, HZ * A), jnp.float32)
    return DuStDraws(actions=actions, params=params, roll=t(noise), roll_comps=t(comps))


@pytest.mark.parametrize("name", list(CASES))
def test_two_chained_option_solves_match_jax(name):
    case = CASES[name]
    jctrl, tctrl = _controllers(case)
    jdist, tdist = _params_dists(case)
    rng = np.random.default_rng(1)
    pol0 = rng.uniform(-1.5, 1.5, (N_POL, HZ, A)).astype(np.float32)
    prims = np.zeros((N_PRIM, HZ, A), np.float32)
    prims[1] = 0.5
    js = jctrl.init(jax.random.PRNGKey(0), pol_mean=jnp.asarray(pol0),
                    action_primitives=jnp.asarray(prims))
    ts = tctrl.init(pol_mean=torch.from_numpy(pol0),
                    action_primitives=torch.from_numpy(prims))
    j_forward = jax.jit(lambda x, s, k: jctrl.forward(x, s, jdist, k, opt_steps=STEPS))
    jx = jnp.asarray(X0, jnp.float32)
    tx = torch.tensor(X0)
    for solve in range(2):
        key = jax.random.PRNGKey(20 + solve)
        draws = jax_forward_draws(key, case, js.prior_weights)
        a_j, js_new, data_j = j_forward(jx, js, key)
        a_t, ts_new, data_t = tctrl.forward(tx, ts, tdist, opt_steps=STEPS, draws=draws)

        cost_shape = (STEPS,) + ((S,) if case["samples"] else ()) + (N,)
        assert tuple(data_t.costs.shape) == cost_shape
        np.testing.assert_allclose(data_t.costs.numpy(), np.array(data_j.costs), rtol=1e-5)
        w_j = np.array(data_j.pol_weights)
        assert int(torch.argmax(data_t.pol_weights)) == int(np.argmax(w_j))
        np.testing.assert_allclose(data_t.pol_weights.numpy(), w_j, rtol=1e-4)
        np.testing.assert_allclose(ts_new.prior_weights.numpy(),
                                   np.array(js_new.prior_weights), rtol=1e-4)
        np.testing.assert_allclose(a_t.numpy(), np.array(a_j), atol=2e-5)
        np.testing.assert_allclose(ts_new.pol_mean.numpy(), np.array(js_new.pol_mean),
                                   atol=2e-5)
        if case.get("adam"):
            for name_ in ("mu", "nu"):
                np.testing.assert_allclose(
                    getattr(ts_new.svgd_state.opt_state, name_).numpy(),
                    np.array(getattr(js_new.svgd_state.opt_state[0], name_)), atol=1e-5)
            if case.get("roll_opt_state"):
                assert not ts_new.svgd_state.opt_state.mu[:, -1].any()
        # the frozen primitives only roll
        if case["roll"] != "resample":
            np.testing.assert_allclose(ts_new.pol_mean[:N_PRIM].numpy(), prims, atol=1e-6)
        frozen = ts.pol_mean[:N_PRIM].numpy()  # unchanged by the solve's steps
        np.testing.assert_allclose(data_t.trace[:, :N_PRIM].numpy(),
                                   np.broadcast_to(frozen, (STEPS + 1,) + frozen.shape),
                                   atol=1e-6)
        if case["roll"] == "resample" and solve == 0:
            # equal inputs and draws; XLA may contract the jitted μ + ε·σ
            np.testing.assert_allclose(ts_new.pol_mean[:, -1].numpy(),
                                       np.array(js_new.pol_mean)[:, -1], rtol=0, atol=1e-6)
        jx = jctrl.model.step(jx[None], a_j[0:1])[0]
        tx = tctrl.model.step(tx[None], a_t[0:1])[0]
        js, ts = js_new, ts_new
    np.testing.assert_allclose(tx.numpy(), np.array(jx), atol=1e-5)


def test_params_dist_none_takes_the_default_parameters():
    """``tests/test_harness.py::test_dust_params_dist_none_with_samples_requested``:
    parameter samples without a distribution solve as with none asked for."""
    case = dict(CASES["mc_params_none"])
    _, tctrl = _controllers(case)
    _, t0 = _controllers({**case, "params": None})
    t0 = dataclasses.replace(t0, n_params_samples=0)
    pol = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (N_POL, HZ, A))
                           .astype(np.float32))
    prims = torch.zeros(N_PRIM, HZ, A)
    draws = DuStDraws(actions=torch.randn(STEPS, S, N, HZ, A,
                                          generator=torch.Generator().manual_seed(0)))
    out = [c.forward(torch.tensor(X0), c.init(pol_mean=pol, action_primitives=prims),
                     None, opt_steps=STEPS, draws=draws) for c in (tctrl, t0)]
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    assert torch.isfinite(out[0][0]).all()


@pytest.mark.parametrize("strategy", ["repeat", "mean", "resample"])
def test_roll_strategies_match_jax(rng, strategy):
    """``_roll`` on equal policies and prior: "repeat" and "resample" (with
    JAX's draws) bit for bit, "mean" at fp32 rounding (rtol 1e-6)."""
    jctrl, tctrl = _controllers({"samples": 0, "params": None, "roll": strategy,
                                 "pol_cov": COV})
    pol = rng.standard_normal((N, HZ, A)).astype(np.float32)
    prior_pol = rng.standard_normal((N, HZ, A)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, N).astype(np.float32)
    jprior = jdu.ParticleGMM(jnp.asarray(prior_pol).reshape(N, -1), jctrl._prior_var(),
                             jnp.asarray(w))
    tprior = du.ParticleGMM(torch.from_numpy(prior_pol).reshape(N, -1),
                            tctrl._prior_var(), torch.from_numpy(w))
    np.testing.assert_array_equal(tctrl._prior_var().numpy(), np.array(jctrl._prior_var()))
    key = jax.random.PRNGKey(7)
    got_j = np.array(jctrl._roll(jnp.asarray(pol), jprior, key))
    key_c, key_n = jax.random.split(key)
    draws = DuStDraws(
        roll=torch.from_numpy(np.array(jax.random.normal(key_n, (N, HZ * A), jnp.float32))),
        roll_comps=torch.from_numpy(np.array(
            jax.random.categorical(key_c, jnp.log(jnp.asarray(w)), shape=(N,)))))
    got_t = tctrl._roll(torch.from_numpy(pol), tprior, draws=draws).numpy()
    if strategy == "mean":
        np.testing.assert_allclose(got_t, got_j, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got_t, got_j)
    np.testing.assert_array_equal(got_t[:, :-1], pol[:, 1:])


def test_generator_draws_and_the_options_that_stay_unported():
    """On the caller's generator the solve runs and repeats; a draw with
    neither generator nor given draws raises ``ValueError``; the trajectory
    mode and the scaled samplers, ported since, run and repeat on the
    generator too (``tests/test_torch_dust_trajectory.py`` holds them
    against JAX)."""
    jctrl, tctrl = _controllers(CASES["mc_cov_full_log_resample"])
    _, tdist = _params_dists(CASES["mc_cov_full_log_resample"])
    pol = torch.zeros(N_POL, HZ, A)
    prims = torch.zeros(N_PRIM, HZ, A)
    cs = tctrl.init(pol_mean=pol, action_primitives=prims)
    runs = [tctrl.forward(torch.tensor(X0), cs, tdist,
                          torch.Generator().manual_seed(3), opt_steps=STEPS)
            for _ in range(2)]
    torch.testing.assert_close(runs[0][1].pol_mean, runs[1][1].pol_mean, rtol=0, atol=0)
    assert tuple(runs[0][2].costs.shape) == (STEPS, S, N)
    assert torch.isfinite(runs[0][1].pol_mean).all()
    with pytest.raises(ValueError, match="Generator"):
        tctrl.forward(torch.tensor(X0), cs, tdist, opt_steps=1)
    with pytest.raises(ValueError, match="Generator|pol_mean"):
        tctrl.init()
    with pytest.raises(ValueError, match="action_primitives"):
        tctrl.init(pol_mean=pol)
    for kw in (dict(kernel_mode="trajectory"), dict(stein_sampler="ScaledSVGD"),
               dict(stein_sampler="MatrixSVGD")):
        other = dataclasses.replace(tctrl, **kw)
        cs2 = other.init(pol_mean=pol, action_primitives=prims)
        runs = [other.forward(torch.tensor(X0), cs2, tdist,
                              torch.Generator().manual_seed(3), opt_steps=STEPS)
                for _ in range(2)]
        torch.testing.assert_close(runs[0][1].pol_mean, runs[1][1].pol_mean, rtol=0, atol=0)
        assert torch.isfinite(runs[0][1].pol_mean).all()
    with pytest.raises(ValueError, match="roll"):
        dataclasses.replace(tctrl, roll_strategy="shift")
    assert tctrl.n_total == jctrl.n_total == N


def test_bench_mc_controller_builds_on_the_flagship_problem():
    """bench.py's MC workload is ``replace(ctrl_sig, n_action_samples=10)``;
    the port's flagship controller takes it (at a small size here)."""
    prob = build_arm_mpc(device="cpu", n_pol=4, hz_len=4)
    ctrl = dataclasses.replace(prob.ctrl, n_action_samples=10)
    cs = ctrl.init(generator=torch.Generator().manual_seed(0))
    a, cs2, data = ctrl.forward(prob.q_start, cs, generator=torch.Generator().manual_seed(1),
                                opt_steps=1)
    assert tuple(data.costs.shape) == (1, 10, 4) and a.shape == (4, 7)
    assert torch.isfinite(cs2.pol_mean).all() and torch.isfinite(data.costs).all()
