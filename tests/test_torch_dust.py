"""The slice as a whole: the port's DuSt MPC solves against the JAX
package's, from one injected controller state.

Setup: the flagship problem of ``bench.py`` (full Panda, ``bookshelf_small``,
exact-SDF occupancy, EE tracking, Adam(0.1), smoothed-box hyper-prior) cut to
16 policies and horizon 8, in signature mode at bandwidth 4.0 with λ=0 (the
JAX block route in Pallas interpret mode, ``solver="pallas_small"``) and
with λ=3 pinned (``solver="pallas"``, the block3 route in interpret mode),
and with λ=3 pinned on linear statics (``lambda3_linear``: JAX's
``pallas_pair_values`` with K5 in interpret mode against K5's twin, held at
the λ=3 mode's fp32 tolerances).
``tests/test_torch_policy.py`` runs the same check in policy mode, and
``tests/test_torch_dust_mc.py`` with action samples (``n_samples``: the
port takes JAX's draws, ``jax_action_draws``). The port takes its state
from ``dust_state_from_numpy``. Two chained ``forward`` calls with
``opt_steps=2`` run on each side.

Per SVGD step, on the JAX step's own policies: costs (rtol 1e-5), K and the
kernel gradient grad_k (scaled by its max), and the Stein velocity φ scaled
by its max (φ adds the FK-driven likelihood gradient to K@s).

The chained outputs: Adam's first steps are about ``lr·sign(φ)``, so an
element whose φ is at fp32 noise can step either way on the two sides. The
returned ``a_seq`` and the rolled ``pol_mean`` are compared on the elements
whose |φ| stayed above 1e-4·max|φ| in every step that moved them; the test
also asserts that this excludes under 1% of them. The chained costs (rtol
1e-5), Adam's first moment and the next joint state (atol 1e-5) are
compared whole.

In the fp32 modes φ is held at 1e-4, the chained policies at 2e-5 and the
first moment at 1e-5. K and grad_k by mode (``MODES``): at λ=0 atol 3e-5 and
5e-5, those of ``test_pallas_block.py``; at λ=3 1e-4 and 4e-4, those of
``test_pallas_block3.py``; in policy mode the sampler's ``GaussianKernel``
K at rtol 1e-5 and dK at rtol 1e-4, atol 1e-5, those of
``tests/test_kernels.py``.

``lambda3_bf16`` is the pinned λ=3 solve with ``grad_precision="bf16"``:
the JAX kernel's gathered pair list with its bf16 delta-form adjoint (K6)
against the port's (K6's bf16 twin). Its values come from the fp32 forward,
so costs (rtol 1e-5) and K (atol 1e-4) hold as at λ=3. Its kernel gradient
does not: both sides round the three delta chains to bf16 (quantum 3.9e-3)
once per operation, but not always at the same operations (XLA's CPU code
may keep a bf16 intermediate wider), so grad_k is held scaled at 1e-2 (it
measures 2e-3 to 3.3e-3). φ is dominated by K@s and holds at 1e-4 as in the
fp32 modes (it measures 5e-6 to 1.2e-5 scaled). The chained policies are
compared on the elements whose |φ| stayed above 1e-3·max|φ| in every step
(the test asserts that this excludes under 5% of them; a 1e-2 cut would
exclude 10% to 13%) at atol 2e-3: Adam's second step moves an element by
about lr·(its second φ relative to its first), and on the kept elements
those ratios carry up to ~1e-2 of relative error. Adam's first moment is
held scaled at 1e-2.
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
from sigsvgd_tpu.experiments.planning import create_body_points as j_body
from sigsvgd_tpu.experiments.planning import sdf_occupancy as j_occ
from sigsvgd_tpu.kernels import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.models.base import DynamicsModel as JDynamicsModel
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot import get_scene as j_get_scene
from sigsvgd_tpu.utils import distributions as jdu
from sigsvgd_tpu.utils.spaces import Box as JBox
from sigsvgd_tpu_torch.controllers.dust import NO_DRAWS, DuStDraws
from sigsvgd_tpu_torch.convert import dust_state_from_numpy
from sigsvgd_tpu_torch.experiments.arm_mpc import (
    CALIBRATION_TOL, Q_START, Q_TARGET, build_arm_mpc,
)
from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

N_POL, HZ, DOF, STEPS = 16, 8, 7, 2


def _jax_ctrl(mode, n_pol=N_POL, n_samples=0):
    """bench.py's flagship problem (``_setup``) at this test's size, with
    the controller of ``mode`` (see ``MODES``) and ``n_samples`` action
    samples."""
    robot = JPandaRobot.create()
    occ = j_occ(j_get_scene("bookshelf_small"))
    low, high = robot.joint_limits()

    @dataclasses.dataclass(frozen=True, eq=False)
    class ArmModel(JDynamicsModel):
        @property
        def observation_space(self):
            return JBox.create(DOF, low=low, high=high)

        @property
        def action_space(self):
            return JBox.create(DOF, low=-2.0, high=2.0)

        def step(self, states, actions, params=None, key=None):
            acts = jnp.clip(actions, -2.0, 2.0)
            return jnp.clip(states + acts * self.dt, low, high)

    ee_target = robot.ee_position(jnp.asarray(Q_TARGET)[None])[0]

    def inst_cost(states, actions=None, **_):
        xs = robot.qs_to_joints_xs(states)
        col = occ(j_body(xs, 4)).mean(-1)
        c = 2.0 * col + jnp.sum((xs[..., -1, :] - ee_target) ** 2, axis=-1)
        if actions is not None:
            c = c + 0.01 * jnp.sum(actions * actions, axis=-1)
        return c

    def term_cost(states, **_):
        ee = robot.qs_to_joints_xs(states)[..., -1, :]
        return 10.0 * jnp.sum((ee - ee_target) ** 2, axis=-1)

    model = ArmModel(dt=0.05)
    common = dict(model=model, hz_len=HZ, n_pol=n_pol, n_action_samples=n_samples,
                  optimizer=optax.adam(0.1), pol_hyper_prior=True,
                  inst_cost_fn=inst_cost, term_cost_fn=term_cost)
    if mode["kernel_mode"] == "policy":
        ctrl = JDuSt(kernel_mode="policy", kernel=JGaussianKernel(),
                     fused_velocity=mode["fused_velocity"], **common)
    else:
        ctrl = JDuSt(kernel_mode="signature",
                     sig_kernel=JSignatureKernel(dyadic_order=mode["order"],
                                                 bandwidth=4.0,
                                                 solver=mode["solver"],
                                                 static=mode.get("static", "rbf"),
                                                 grad_precision=mode.get(
                                                     "grad_precision", "fp32")),
                     **common)
    return ctrl, model


def _port_problem(mode, n_pol=N_POL, n_samples=0):
    if mode["kernel_mode"] == "policy":
        prob = build_arm_mpc(device="cpu", n_pol=n_pol, hz_len=HZ,
                             kernel_mode="policy",
                             fused_velocity=mode["fused_velocity"])
    else:
        prob = build_arm_mpc(device="cpu", n_pol=n_pol, hz_len=HZ,
                             dyadic_order=mode["order"], calibrate=False,
                             grad_precision=mode.get("grad_precision", "fp32"),
                             static=mode.get("static", "rbf"))
    return dataclasses.replace(
        prob, ctrl=dataclasses.replace(prob.ctrl, n_action_samples=n_samples))


MODES = {
    "lambda0": dict(kernel_mode="signature", order=0, solver="pallas_small",
                    k_atol=3e-5, gk_atol=5e-5),
    "lambda3": dict(kernel_mode="signature", order=3, solver="pallas",
                    k_atol=1e-4, gk_atol=4e-4),
    # linear statics: the pair list on increments (K5) on both sides
    "lambda3_linear": dict(kernel_mode="signature", order=3, solver="pallas",
                           static="linear", k_atol=1e-4, gk_atol=4e-4),
    # the bf16 adjoint: see the module docstring
    "lambda3_bf16": dict(kernel_mode="signature", order=3, solver="pallas",
                         grad_precision="bf16", k_atol=1e-4, gk_atol=1e-2,
                         keep_rel=1e-3, keep_frac=0.95, pol_atol=2e-3,
                         mu_scaled=1e-2),
    # the sampler's own GaussianKernel: K at rtol 1e-5 and dK at rtol 1e-4,
    # atol 1e-5, as tests/test_kernels.py holds it
    "policy": dict(kernel_mode="policy", fused_velocity=False),
    "policy_fused": dict(kernel_mode="policy", fused_velocity=True),
}


def _n(a):
    return np.array(a)


def _scaled_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def jax_action_draws(key, steps, shape):
    """The action samples JAX's ``DuSt.forward`` draws from ``key``: its
    key schedule (``key, key_par = split(key)``, then ``opt_steps + 1``
    keys), one ``normal(keys[t], shape)`` a step; returns the step keys and
    the draws, stacked."""
    key, _key_par = jax.random.split(key)
    keys = jax.random.split(key, steps + 1)[:steps]
    return keys, np.stack([_n(jax.random.normal(k, shape, jnp.float32)) for k in keys])


def run_two_chained_solves(mode_name, seed=0, n_pol=N_POL, n_samples=0):
    """Two chained solves on each side, checked as the module docstring
    says; with ``n_samples`` action samples the port takes JAX's draws."""
    mode = MODES[mode_name]
    rng = np.random.default_rng(seed)
    jctrl, jmodel = _jax_ctrl(mode, n_pol, n_samples)
    prob = _port_problem(mode, n_pol, n_samples)
    tctrl = prob.ctrl
    assert tctrl.kernel_mode == mode["kernel_mode"]
    if mode["kernel_mode"] == "signature":
        assert tctrl.sig_kernel.dyadic_order == mode["order"]
        assert tctrl.sig_kernel.grad_precision == mode.get("grad_precision", "fp32")
        assert tctrl.sig_kernel.static == mode.get("static", "rbf")
    jsampler, tsampler = jctrl._sampler(), tctrl._sampler()
    phi_atol, keep_rel = mode.get("phi_atol", 1e-4), mode.get("keep_rel", 1e-4)

    pol0 = rng.uniform(-2.0, 2.0, size=(n_pol, HZ, DOF)).astype(np.float32)
    js = jctrl.init(jax.random.PRNGKey(0), pol_mean=jnp.asarray(pol0))
    adam = js.svgd_state.opt_state[0]
    ts = dust_state_from_numpy(
        _n(js.pol_mean), _n(js.prior_weights), _n(adam.count), _n(adam.mu),
        _n(adam.nu), _n(js.svgd_state.step), device="cpu",
    )
    jq = jnp.asarray(Q_START, jnp.float32)
    tq = prob.q_start
    # jitted once each: eager JAX dispatch of the FK graph takes ~30 s a call
    j_forward = jax.jit(lambda q, s, k: jctrl.forward(q, s, None, k, opt_steps=STEPS))
    j_score = jax.jit(lambda p, q, pr, k: jctrl._score(p, q, pr, None, k))
    j_velocity = jax.jit(jsampler.velocity)
    keep = np.ones((n_pol, HZ, DOF), bool)  # elements whose φ was never noise
    for solve in range(2):
        key = jax.random.PRNGKey(10 + solve)
        keys, eps = jax_action_draws(key, STEPS, (n_samples, n_pol, HZ, DOF))
        a_j, js_new, data_j = j_forward(jq, js, key)
        draws = DuStDraws(actions=torch.from_numpy(eps)) if n_samples else NO_DRAWS
        a_t, ts_new, data_t = tctrl.forward(tq, ts, opt_steps=STEPS, draws=draws)

        # per-step internals on the JAX step's own policies
        prior_j = jdu.ParticleGMM(js.pol_mean.reshape(n_pol, -1),
                                  jctrl._prior_var(), js.prior_weights)
        prior_t = ParticleGMM(torch.from_numpy(_n(js.pol_mean)).reshape(n_pol, -1),
                              tctrl._prior_var(),
                              torch.from_numpy(_n(js.prior_weights)))
        tq_j = torch.from_numpy(_n(jq))
        for t in range(STEPS):
            pol = data_j.trace[t]
            score_j, _ = j_score(pol, jq, prior_j, keys[t] if n_samples else key)
            phi_j, _ = j_velocity(pol, score_j, jnp.asarray(t))
            pol_t = torch.from_numpy(_n(pol))
            score_t, _ = tctrl._score(pol_t, tq_j, prior_t, None,
                                      torch.from_numpy(eps[t]) if n_samples else None)
            phi_t, _ = tsampler.velocity(pol_t, score_t, torch.tensor(t))
            np.testing.assert_allclose(score_t.aux["costs"].numpy(),
                                       _n(score_j.aux["costs"]), rtol=1e-5)
            if mode["kernel_mode"] == "signature":
                np.testing.assert_allclose(score_t.k_xx.numpy(), _n(score_j.k_xx),
                                           atol=mode["k_atol"])
                _scaled_close(score_t.grad_k.numpy(), _n(score_j.grad_k),
                              mode["gk_atol"])
            else:
                assert score_t.k_xx is None and score_j.k_xx is None
                k_t, dk_t = tsampler._kernel_terms(pol_t)
                k_j, dk_j = jsampler._kernel_terms(pol)
                np.testing.assert_allclose(k_t.numpy(), _n(k_j), rtol=1e-5)
                np.testing.assert_allclose(dk_t.numpy(), _n(dk_j), rtol=1e-4,
                                           atol=1e-5)
            _scaled_close(phi_t.numpy(), _n(phi_j), phi_atol)
            phi = np.abs(_n(phi_j))
            keep &= phi > keep_rel * phi.max()
            np.testing.assert_allclose(data_t.costs[t].numpy(), _n(data_j.costs[t]),
                                       rtol=1e-5)

        assert keep.mean() > mode.get("keep_frac", 0.99)
        pol_atol = mode.get("pol_atol", 2e-5)
        i_star = int(np.argmax(_n(data_j.pol_weights)))
        assert int(torch.argmax(data_t.pol_weights)) == i_star
        np.testing.assert_allclose(a_t.numpy()[keep[i_star]],
                                   _n(a_j)[keep[i_star]], atol=pol_atol)
        # the roll shifts the horizon; the repeated last step inherits the mask
        keep = np.concatenate([keep[:, 1:], keep[:, -1:]], axis=1)
        np.testing.assert_allclose(ts_new.pol_mean.numpy()[keep],
                                   _n(js_new.pol_mean)[keep], atol=pol_atol)
        mu_t = ts_new.svgd_state.opt_state.mu.numpy()
        mu_j = _n(js_new.svgd_state.opt_state[0].mu)
        if "mu_scaled" in mode:
            _scaled_close(mu_t, mu_j, mode["mu_scaled"])
        else:
            np.testing.assert_allclose(mu_t, mu_j, atol=1e-5)
        assert int(ts_new.svgd_state.step) == int(js_new.svgd_state.step)

        jq = jmodel.step(jq[None], a_j[0:1])[0]
        tq = prob.model.step(tq[None], a_t[0:1])[0]
        js, ts = js_new, ts_new
    np.testing.assert_allclose(tq.numpy(), _n(jq), atol=1e-5)


@pytest.mark.parametrize("mode_name", ["lambda0", "lambda3", "lambda3_bf16",
                                       "lambda3_linear"],
                         ids=["0", "lambda3", "lambda3_bf16", "lambda3_linear"])
def test_two_chained_mpc_solves_match_jax(mode_name):
    run_two_chained_solves(mode_name)


def test_build_arm_mpc_calibration_keeps_or_drops_order_3():
    """bench.py's three controllers: a calibration whose z³ bound exceeds
    the tolerance keeps order 3 (``_setup``), one within it drops to 0,
    ``calibrate=False`` pins the configured order (``ctrl_sig_pinned``), and
    policy mode has no signature kernel to calibrate (``ctrl_rbf``)."""
    kept = build_arm_mpc(device="cpu", n_pol=8, hz_len=8, bandwidth=0.5)
    assert kept.calibration_bound > CALIBRATION_TOL
    assert kept.ctrl.sig_kernel.dyadic_order == 3
    dropped = build_arm_mpc(device="cpu", n_pol=8, hz_len=8, bandwidth=4.0)
    assert dropped.calibration_bound <= CALIBRATION_TOL
    assert dropped.ctrl.sig_kernel.dyadic_order == 0
    pinned = build_arm_mpc(device="cpu", n_pol=8, hz_len=8, bandwidth=4.0,
                           calibrate=False)
    assert pinned.ctrl.sig_kernel.dyadic_order == 3
    assert pinned.calibration_bound == dropped.calibration_bound
    policy = build_arm_mpc(device="cpu", n_pol=8, hz_len=8, kernel_mode="policy")
    assert policy.ctrl.kernel_mode == "policy" and policy.calibration_bound is None
