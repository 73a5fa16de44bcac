"""The port's DuSt in the trajectory kernel mode and with the ScaledSVGD and
MatrixSVGD samplers, against the JAX controller with the same draws.

On the point mass of ``tests/test_torch_distributions.py`` (4 policies + 2
frozen primitives, horizon 6, Adam(0.05)), two chained solves a case with
JAX's draws handed to the port (``DuStDraws``, on the key schedule of
``tests/test_torch_dust_mc.py``):

* ``trajectory``: the trajectory mode with DuSt's default
  ``GaussianKernel``, the autograd likelihood;
* ``trajectory_mc``: the trajectory mode with 4 action samples and a
  ``ScaledGaussianKernel`` (the shape of
  ``tests/test_controllers.py::test_dust_trajectory_kernel_mode``);
* ``matrix_policy`` and ``scaled_policy``: MatrixSVGD with a
  ``ScaledGaussianKernel`` and ScaledSVGD with the default
  ``GaussianKernel`` (which ignores the metric) in policy mode;
* ``matrix_trajectory``: MatrixSVGD in the trajectory mode, whose sampler
  discards the trajectory kernel terms as JAX's does: its solves equal the
  policy-mode MatrixSVGD solves on the same draws.

Held as ``tests/test_torch_dust_mc.py`` holds its solves: costs rtol 1e-5,
the weights' argmax, the weights rtol 1e-4, ``a_seq`` and the rolled
policies atol 2e-5, Adam's moments atol 1e-5, the primitives unchanged.
On the first solve's policies, each step's trajectory kernel terms: K at
rtol 1e-5 and its gradient in the policies at rtol 1e-4 / atol 1e-5 (the
kernel tests' K and dK tolerances).
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
from sigsvgd_tpu.kernels import ScaledGaussianKernel as JScaledGaussianKernel
from sigsvgd_tpu.utils import distributions as jdu
from sigsvgd_tpu_torch.controllers.dust import DuSt
from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
from sigsvgd_tpu_torch.inference.svgd import Adam, ScaledSVGD
from sigsvgd_tpu_torch.kernels.rbf import GaussianKernel, ScaledGaussianKernel
from sigsvgd_tpu_torch.utils.distributions import ParticleGMM
from test_torch_distributions import JPointMass, PointMass, point_mass_costs
from test_torch_dust_mc import HZ, N, N_POL, N_PRIM, S, STEPS, X0, jax_forward_draws

CASES = {
    "trajectory": dict(mode="trajectory", sampler="SVGD", samples=0, scaled=False),
    "trajectory_mc": dict(mode="trajectory", sampler="SVGD", samples=S, scaled=True),
    "matrix_policy": dict(mode="policy", sampler="MatrixSVGD", samples=0, scaled=True),
    "scaled_policy": dict(mode="policy", sampler="ScaledSVGD", samples=0, scaled=False),
    "matrix_trajectory": dict(mode="trajectory", sampler="MatrixSVGD", samples=0,
                              scaled=True),
}


def _controllers(case):
    inst_j, term_j = point_mass_costs(jnp)
    inst_t, term_t = point_mass_costs(torch)
    common = dict(hz_len=HZ, n_pol=N_POL, n_prim=N_PRIM, kernel_mode=case["mode"],
                  stein_sampler=case["sampler"], n_action_samples=case["samples"])
    jctrl = JDuSt(model=JPointMass(dt=0.1), optimizer=optax.adam(0.05),
                  kernel=JScaledGaussianKernel() if case["scaled"] else JGaussianKernel(),
                  inst_cost_fn=inst_j, term_cost_fn=term_j, **common)
    tctrl = DuSt(model=PointMass(dt=0.1), optimizer=Adam(0.05), device="cpu",
                 kernel=ScaledGaussianKernel() if case["scaled"] else GaussianKernel(),
                 inst_cost_fn=inst_t, term_cost_fn=term_t, **common)
    return jctrl, tctrl


def _solve_twice(case):
    """Two chained solves on each side, checked as the module docstring
    says; returns the port's outputs."""
    jctrl, tctrl = _controllers(case)
    assert isinstance(tctrl._sampler(), ScaledSVGD) == (case["sampler"] != "SVGD")
    rng = np.random.default_rng(1)
    pol0 = rng.uniform(-1.5, 1.5, (N_POL, HZ, 2)).astype(np.float32)
    prims = np.zeros((N_PRIM, HZ, 2), np.float32)
    prims[1] = 0.5
    js = jctrl.init(jax.random.PRNGKey(0), pol_mean=jnp.asarray(pol0),
                    action_primitives=jnp.asarray(prims))
    ts = tctrl.init(pol_mean=torch.from_numpy(pol0),
                    action_primitives=torch.from_numpy(prims))
    j_forward = jax.jit(lambda x, s, k: jctrl.forward(x, s, None, k, opt_steps=STEPS))
    jx, tx = jnp.asarray(X0, jnp.float32), torch.tensor(X0)
    dcase = {"samples": case["samples"], "params": None}
    outs = []
    for solve in range(2):
        key = jax.random.PRNGKey(30 + solve)
        draws = jax_forward_draws(key, dcase, js.prior_weights)
        a_j, js_new, data_j = j_forward(jx, js, key)
        a_t, ts_new, data_t = tctrl.forward(tx, ts, None, opt_steps=STEPS, draws=draws)
        if solve == 0 and case["mode"] == "trajectory":
            _check_kernel_terms(jctrl, tctrl, js, jx, key, data_j, draws)
        np.testing.assert_allclose(data_t.costs.numpy(), np.array(data_j.costs), rtol=1e-5)
        w_j = np.array(data_j.pol_weights)
        assert int(torch.argmax(data_t.pol_weights)) == int(np.argmax(w_j))
        np.testing.assert_allclose(data_t.pol_weights.numpy(), w_j, rtol=1e-4)
        np.testing.assert_allclose(a_t.numpy(), np.array(a_j), atol=2e-5)
        np.testing.assert_allclose(ts_new.pol_mean.numpy(), np.array(js_new.pol_mean),
                                   atol=2e-5)
        for name in ("mu", "nu"):
            np.testing.assert_allclose(
                getattr(ts_new.svgd_state.opt_state, name).numpy(),
                np.array(getattr(js_new.svgd_state.opt_state[0], name)), atol=1e-5)
        frozen = ts.pol_mean[:N_PRIM].numpy()
        np.testing.assert_array_equal(data_t.trace[:, :N_PRIM].numpy(),
                                      np.broadcast_to(frozen, (STEPS + 1,) + frozen.shape))
        assert torch.isfinite(ts_new.pol_mean).all()
        outs.append((a_t, ts_new.pol_mean, data_t.costs))
        jx = jctrl.model.step(jx[None], a_j[0:1])[0]
        tx = tctrl.model.step(tx[None], a_t[0:1])[0]
        js, ts = js_new, ts_new
    np.testing.assert_allclose(tx.numpy(), np.array(jx), atol=1e-5)
    return outs


def _check_kernel_terms(jctrl, tctrl, js, jx, key, data_j, draws):
    """Each step's trajectory kernel terms on JAX's own policies."""
    key, _ = jax.random.split(key)
    keys = jax.random.split(key, STEPS + 1)
    prior_j = jdu.ParticleGMM(js.pol_mean.reshape(N, -1), jctrl._prior_var(),
                              js.prior_weights)
    prior_t = ParticleGMM(torch.from_numpy(np.array(js.pol_mean)).reshape(N, -1),
                          tctrl._prior_var(), torch.from_numpy(np.array(js.prior_weights)))
    j_score = jax.jit(lambda p, k: jctrl._score(p, jx, prior_j, None, k))
    for t in range(STEPS):
        pol = data_j.trace[t]
        score_j, _ = j_score(pol, keys[t])
        eps = None if draws.actions is None else draws.actions[t]
        score_t, _ = tctrl._score(torch.from_numpy(np.array(pol)),
                                  torch.from_numpy(np.array(jx)), prior_t, None, eps)
        np.testing.assert_allclose(score_t.k_xx.numpy(), np.array(score_j.k_xx), rtol=1e-5)
        np.testing.assert_allclose(score_t.grad_k.numpy(), np.array(score_j.grad_k),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", [n for n in CASES if n != "matrix_trajectory"])
def test_two_chained_solves_match_jax(name):
    _solve_twice(CASES[name])


def test_matrix_svgd_discards_the_trajectory_kernel_terms():
    """MatrixSVGD in the trajectory mode matches JAX's and solves exactly as
    in policy mode: its velocity never reads the trajectory Gram."""
    traj = _solve_twice(CASES["matrix_trajectory"])
    _, tpol = _controllers(CASES["matrix_policy"])
    _, ttraj = _controllers(CASES["matrix_trajectory"])
    pol = torch.from_numpy(np.random.default_rng(1).uniform(-1.5, 1.5, (N_POL, HZ, 2))
                           .astype(np.float32))
    prims = torch.zeros(N_PRIM, HZ, 2)
    prims[1] = 0.5
    runs = [c.forward(torch.tensor(X0), c.init(pol_mean=pol, action_primitives=prims),
                      None, opt_steps=STEPS) for c in (tpol, ttraj)]
    assert torch.equal(runs[0][1].pol_mean, runs[1][1].pol_mean)
    assert torch.equal(runs[0][1].pol_mean, traj[0][1])


def test_trajectory_kernel_terms_follow_the_bandwidth_rule():
    """A kernel with a ``bandwidth_fn`` chooses its own bandwidth; without
    one the median of :func:`bw_median_diff` is used (its gradient in the
    policies included), and every mode and sampler of the JAX ``DuSt`` is
    accepted."""
    _, tctrl = _controllers(CASES["trajectory"])
    pol = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (N, HZ, 2))
                           .astype(np.float32))
    k_med, g_med = tctrl._kernel_terms(pol, torch.tensor(X0))
    fixed = dataclasses.replace(tctrl, kernel=GaussianKernel(bandwidth_fn=lambda d: 0.7))
    k_fix, g_fix = fixed._kernel_terms(pol, torch.tensor(X0))
    assert k_med.shape == k_fix.shape == (N, N) and g_fix.shape == pol.shape
    np.testing.assert_allclose(torch.diagonal(k_fix).numpy(), 1.0, atol=1e-6)
    assert not torch.allclose(k_med, k_fix)
    for mode in ("policy", "trajectory", "signature"):
        for sampler in ("SVGD", "ScaledSVGD", "MatrixSVGD"):
            ctrl = dataclasses.replace(tctrl, kernel_mode=mode, stein_sampler=sampler)
            assert (ctrl.kernel_mode, ctrl.stein_sampler) == (mode, sampler)
    for field, value in (("kernel_mode", "rbf"), ("stein_sampler", "SGLD")):
        with pytest.raises(ValueError, match=field.split("_")[-1]):
            dataclasses.replace(tctrl, **{field: value})


def test_arm_mpc_builds_the_new_controllers():
    """``build_arm_mpc``'s trajectory mode, samplers and kernel, at a small
    size: one solve each, finite; and the JAX DuSt default signature kernel
    (order 2, the wavefront) and the calibrated linear-static kernel run."""
    for kw in (dict(kernel_mode="trajectory"),
               dict(kernel_mode="policy", stein_sampler="MatrixSVGD",
                    kernel=ScaledGaussianKernel()),
               dict(kernel_mode="trajectory", stein_sampler="ScaledSVGD"),
               dict(dyadic_order=2, calibrate=False, bandwidth=None),
               dict(static="linear")):
        prob = build_arm_mpc(device="cpu", n_pol=4, hz_len=4, **kw)
        cs = prob.ctrl.init(generator=torch.Generator().manual_seed(0))
        a, cs2, data = prob.ctrl.forward(prob.q_start, cs, opt_steps=1)
        assert a.shape == (4, 7) and torch.isfinite(cs2.pol_mean).all()
        assert torch.isfinite(data.costs).all()
    assert prob.ctrl.sig_kernel.static == "linear"
    assert prob.ctrl.sig_kernel.dyadic_order in (0, 3)
