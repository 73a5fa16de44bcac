"""The port's toy targets and its gymnasium cross-check against the JAX
package's on the CPU.

* ``models/toy.py``: ``DoubleBanana`` and ``Sine`` (``logp``, the score and
  the banana's Hessian) and ``StarGaussian`` (``logp`` and the score) within
  1e-6 of JAX's on the same points. They are compared in fp64: the star's
  components have variance 1/100, whose inverse amplifies fp32 rounding to
  ~2e-4 relative in the score. ``star_gaussian``'s fp32 means and
  covariances within 1e-6; ``sample`` from a generator, with the mixture's
  mean.
* ``experiments/gym_sim.py`` with ``tests/test_gym_crossval.py``'s checks:
  the pendulum and cartpole steps against gymnasium's physics (rtol 1e-5 /
  atol 1e-5, rtol 1e-4 / atol 1e-5), and the closed-loop DuSt swing-up on
  Pendulum-v1 reaching and holding upright; its first steps' actions within
  1e-4 of JAX's ``run_gym_pendulum`` from the same policies (no draws).
  These skip without gymnasium.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigsvgd_tpu.controllers import DuSt as JDuSt
from sigsvgd_tpu.experiments import gym_sim as jgym
from sigsvgd_tpu.models import toy as jtoy
from sigsvgd_tpu_torch.controllers.dust import DuSt
from sigsvgd_tpu_torch.experiments import gym_sim
from sigsvgd_tpu_torch.inference.svgd import Adam
from sigsvgd_tpu_torch.models import toy
from sigsvgd_tpu_torch.models.cartpole import CartPoleModel

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def gym():
    return pytest.importorskip("gymnasium")


@pytest.mark.parametrize("name", ["banana", "sine"])
def test_analytic_targets_match_jax(rng, name):
    x = rng.uniform(-2.0, 2.0, (64, 2))
    jt, tt = {"banana": (jtoy.DoubleBanana(), toy.DoubleBanana()),
              "sine": (jtoy.Sine(), toy.Sine())}[name]
    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        want = [jax.jit(jt.logp)(xj), jax.jit(jt.grad_log_p)(xj)]
        if name == "banana":
            want.append(jax.jit(jt.hessian_log_p)(xj))
    xt = torch.from_numpy(x)
    got = [tt.logp(xt), tt.grad_log_p(xt)]
    if name == "banana":
        got.append(tt.hessian_log_p(xt))
        assert got[-1].shape == (64, 2, 2)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_star_gaussian_matches_jax(rng):
    js, ts = jtoy.star_gaussian(), toy.star_gaussian(device="cpu")
    assert ts.mus.dtype == torch.float32
    np.testing.assert_allclose(ts.mus.numpy(), np.asarray(js.mus), **TOL)
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas), **TOL)
    x = rng.uniform(-2.5, 2.5, (64, 2))
    mus, sigmas = np.asarray(js.mus, np.float64), np.asarray(js.sigmas, np.float64)
    with jax.enable_x64(True):
        j64 = jtoy.StarGaussian(jnp.asarray(mus), jnp.asarray(sigmas))
        want = [jax.jit(j64.logp)(jnp.asarray(x)), jax.jit(j64.grad_log_p)(jnp.asarray(x))]
    t64 = toy.StarGaussian(torch.from_numpy(mus), torch.from_numpy(sigmas))
    xt = torch.from_numpy(x)
    for a, b in zip([t64.logp(xt), t64.grad_log_p(xt)], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # a [.., 2] batch of any rank
    assert ts.logp(torch.zeros(3, 4, 2)).shape == (3, 4)
    s1 = ts.sample(20000, torch.Generator().manual_seed(0))
    s2 = ts.sample(20000, torch.Generator().manual_seed(0))
    assert s1.shape == (20000, 2) and torch.equal(s1, s2)
    np.testing.assert_allclose(s1.mean(0).numpy(), ts.mus.mean(0).numpy(), atol=0.05)


def test_pendulum_step_matches_gymnasium(gym):
    env = gym.make("Pendulum-v1")
    env.reset(seed=0)
    model = gym_sim.gym_pendulum_model(dt=0.05)
    rng = np.random.default_rng(0)
    for _ in range(25):
        th, thd, u = rng.uniform(-np.pi, np.pi), rng.uniform(-7, 7), rng.uniform(-3, 3)
        env.unwrapped.state = np.array([th, thd])
        env.step(np.array([u], np.float32))
        got = model.step(torch.tensor([[th, thd]], dtype=torch.float32),
                         torch.tensor([[u]], dtype=torch.float32))[0]
        np.testing.assert_allclose(got.numpy(), env.unwrapped.state.astype(np.float32),
                                   rtol=1e-5, atol=1e-5)
    env.close()


def test_cartpole_step_matches_gymnasium(gym):
    env = gym.make("CartPole-v1")
    env.reset(seed=0)
    model = CartPoleModel(dt=0.02, g=9.8, mass_cart=1.0, mass_pole=0.1, length=0.5,
                          mu_c=0.0, mu_p=0.0, f_mag=10.0, reference_mass_bug=False)
    rng = np.random.default_rng(1)
    for _ in range(25):
        s = rng.uniform([-1, -1, -0.2, -1], [1, 1, 0.2, 1]).astype(np.float32)
        a = rng.integers(0, 2)
        env.unwrapped.state = s.astype(np.float64)
        env.step(int(a))
        want = np.asarray(env.unwrapped.state, np.float32)
        got = model.step(torch.from_numpy(s)[None],
                         torch.tensor([[1.0 if a == 1 else -1.0]]))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    env.close()


def test_closed_loop_dust_on_gym_pendulum(gym):
    """``test_closed_loop_dust_on_gym_pendulum`` on the port, from JAX's
    initial policies; the first 5 steps against JAX's episode."""
    model = gym_sim.gym_pendulum_model()
    jmodel = jgym.gym_pendulum_model()
    common = dict(hz_len=20, n_pol=16, kernel_mode="policy")
    jctrl = JDuSt(model=jmodel, optimizer=optax.adam(0.3),
                  inst_cost_fn=jmodel.swingup_inst_cost,
                  term_cost_fn=jmodel.swingup_term_cost, **common)
    ctrl = DuSt(model=model, device="cpu", optimizer=Adam(0.3),
                inst_cost_fn=model.swingup_inst_cost,
                term_cost_fn=model.swingup_term_cost, **common)
    jc = jctrl.init(jax.random.PRNGKey(0))
    pol0 = torch.tensor(np.asarray(jc.pol_mean))
    out = gym_sim.run_gym_pendulum(ctrl, ctrl.init(pol_mean=pol0), n_steps=100, seed=0,
                                   opt_steps=3)
    thetas = out["states"][:, 0]
    upright_err = np.abs((thetas + np.pi) % (2 * np.pi) - np.pi)
    assert upright_err.min() < 0.1, f"never reached upright: {upright_err.min()}"
    assert upright_err[-10:].max() < 0.5, upright_err[-10:]
    assert out["actions"].shape == (100, 1) and out["rewards"].shape == (100,)
    want = jgym.run_gym_pendulum(jctrl, jc, n_steps=5, seed=0, opt_steps=3)
    np.testing.assert_allclose(out["actions"][:5], want["actions"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["states"][:6], want["states"], rtol=1e-4, atol=1e-4)
