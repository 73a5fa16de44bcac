"""The slice as a whole: the port's signature-kernel DuSt MPC solve against the
JAX package's, from one injected controller state.

Setup: the flagship problem of ``bench.py`` (full Panda, ``bookshelf_small``,
exact-SDF occupancy, EE tracking, Adam(0.1), smoothed-box hyper-prior) cut to
16 policies and horizon 8, λ=0, bandwidth 4.0. The JAX side runs its block
route in Pallas interpret mode (``solver="pallas_small"``). The port takes
its state from ``dust_state_from_numpy``. Two chained ``forward`` calls with
``opt_steps=2`` run on each side.

Per SVGD step, on the JAX step's own policies: costs (rtol 1e-5), K (atol
3e-5), the kernel gradient grad_k and the Stein velocity φ (scaled by their
max, atol 5e-5 and 1e-4: φ adds the FK-driven likelihood gradient to K@s).

The chained outputs: Adam's first steps are about ``lr·sign(φ)``, so an
element whose φ is at fp32 noise can step either way on the two sides. The
returned ``a_seq`` and the rolled ``pol_mean`` are compared (atol 2e-5) on
the elements whose |φ| stayed above 1e-4·max|φ| in every step that moved
them; the test also asserts that this excludes under 1% of them. The chained
costs (rtol 1e-5), Adam's first moment (atol 1e-5) and the next joint state
(atol 1e-5) are compared whole.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigsvgd_tpu.controllers import DuSt as JDuSt
from sigsvgd_tpu.experiments.planning import create_body_points as j_body
from sigsvgd_tpu.experiments.planning import sdf_occupancy as j_occ
from sigsvgd_tpu.kernels import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.models.base import DynamicsModel as JDynamicsModel
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot import get_scene as j_get_scene
from sigsvgd_tpu.utils import distributions as jdu
from sigsvgd_tpu.utils.spaces import Box as JBox
from sigsvgd_tpu_torch.convert import dust_state_from_numpy
from sigsvgd_tpu_torch.experiments.arm_mpc import Q_START, Q_TARGET, build_arm_mpc
from sigsvgd_tpu_torch.utils.distributions import ParticleGMM

N_POL, HZ, DOF, STEPS = 16, 8, 7, 2


def _jax_ctrl():
    """bench.py's flagship problem (``_setup``) at this test's size."""
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
    ctrl = JDuSt(
        model=model, hz_len=HZ, n_pol=N_POL, n_action_samples=0,
        optimizer=optax.adam(0.1), pol_hyper_prior=True,
        inst_cost_fn=inst_cost, term_cost_fn=term_cost, kernel_mode="signature",
        sig_kernel=JSignatureKernel(dyadic_order=0, bandwidth=4.0,
                                    solver="pallas_small"),
    )
    return ctrl, model


def _n(a):
    return np.array(a)


def _scaled_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("seed", [0])
def test_two_chained_mpc_solves_match_jax(seed):
    rng = np.random.default_rng(seed)
    jctrl, jmodel = _jax_ctrl()
    prob = build_arm_mpc(device="cpu", n_pol=N_POL, hz_len=HZ, dyadic_order=0)
    tctrl = prob.ctrl
    jsampler, tsampler = jctrl._sampler(), tctrl._sampler()

    pol0 = rng.uniform(-2.0, 2.0, size=(N_POL, HZ, DOF)).astype(np.float32)
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
    keep = np.ones((N_POL, HZ, DOF), bool)  # elements whose φ was never noise
    for solve in range(2):
        key = jax.random.PRNGKey(10 + solve)
        a_j, js_new, data_j = j_forward(jq, js, key)
        a_t, ts_new, data_t = tctrl.forward(tq, ts, opt_steps=STEPS)

        # per-step internals on the JAX step's own policies
        prior_j = jdu.ParticleGMM(js.pol_mean.reshape(N_POL, -1),
                                  jctrl._prior_var(), js.prior_weights)
        prior_t = ParticleGMM(torch.from_numpy(_n(js.pol_mean)).reshape(N_POL, -1),
                              tctrl._prior_var(),
                              torch.from_numpy(_n(js.prior_weights)))
        tq_j = torch.from_numpy(_n(jq))
        for t in range(STEPS):
            pol = data_j.trace[t]
            score_j, _ = j_score(pol, jq, prior_j, key)
            phi_j, _ = j_velocity(pol, score_j, jnp.asarray(t))
            pol_t = torch.from_numpy(_n(pol))
            score_t, _ = tctrl._score(pol_t, tq_j, prior_t)
            phi_t, _ = tsampler.velocity(pol_t, score_t)
            np.testing.assert_allclose(score_t.aux["costs"].numpy(),
                                       _n(score_j.aux["costs"]), rtol=1e-5)
            np.testing.assert_allclose(score_t.k_xx.numpy(), _n(score_j.k_xx),
                                       atol=3e-5)
            _scaled_close(score_t.grad_k.numpy(), _n(score_j.grad_k), 5e-5)
            _scaled_close(phi_t.numpy(), _n(phi_j), 1e-4)
            phi = np.abs(_n(phi_j))
            keep &= phi > 1e-4 * phi.max()
            np.testing.assert_allclose(data_t.costs[t].numpy(), _n(data_j.costs[t]),
                                       rtol=1e-5)

        assert keep.mean() > 0.99
        i_star = int(np.argmax(_n(data_j.pol_weights)))
        assert int(torch.argmax(data_t.pol_weights)) == i_star
        np.testing.assert_allclose(a_t.numpy()[keep[i_star]],
                                   _n(a_j)[keep[i_star]], atol=2e-5)
        # the roll shifts the horizon; the repeated last step inherits the mask
        keep = np.concatenate([keep[:, 1:], keep[:, -1:]], axis=1)
        np.testing.assert_allclose(ts_new.pol_mean.numpy()[keep],
                                   _n(js_new.pol_mean)[keep], atol=2e-5)
        np.testing.assert_allclose(ts_new.svgd_state.opt_state.mu.numpy(),
                                   _n(js_new.svgd_state.opt_state[0].mu), atol=1e-5)
        assert int(ts_new.svgd_state.step) == int(js_new.svgd_state.step)

        jq = jmodel.step(jq[None], a_j[0:1])[0]
        tq = prob.model.step(tq[None], a_t[0:1])[0]
        js, ts = js_new, ts_new
    np.testing.assert_allclose(tq.numpy(), _n(jq), atol=1e-5)
