"""Port foundations against the JAX package: ``utils/math``, ``Box``, Adam,
the rollout, the state converter, and the port's import isolation.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are fp32 ones: 1e-6 relative on values, and exact on the tie
gradients the port reproduces on purpose.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigsvgd_tpu.models.base import DynamicsModel as JDynamicsModel
from sigsvgd_tpu.models.rollout import rollout as jrollout
from sigsvgd_tpu.utils import math as jm
from sigsvgd_tpu.utils.spaces import Box as JBox
from sigsvgd_tpu_torch.convert import dust_state_from_numpy
from sigsvgd_tpu_torch.inference.svgd import Adam
from sigsvgd_tpu_torch.models.base import DynamicsModel
from sigsvgd_tpu_torch.models.rollout import rollout
from sigsvgd_tpu_torch.utils import math as tm
from sigsvgd_tpu_torch.utils.spaces import Box

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tgrad(fn, x):
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(fn(xt).sum(), xt)
    return g.numpy()


def _jgrad(fn, x):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v)))(jnp.asarray(x, jnp.float32)))


def test_safe_norm_and_pw_dist_sq(rng):
    x = rng.normal(size=(9, 4)).astype(np.float32)
    y = rng.normal(size=(6, 4)).astype(np.float32)
    x[0] = 0.0
    np.testing.assert_allclose(tm.safe_norm(_t(x)).numpy(),
                               np.asarray(jm.safe_norm(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(_tgrad(tm.safe_norm, x), _jgrad(jm.safe_norm, x),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.pw_dist_sq(_t(x), _t(y)).numpy(),
                               np.asarray(jm.pw_dist_sq(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [10, 11])
def test_bw_median_matches(rng, n):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    d2 = np.asarray(jm.pw_dist_sq(jnp.asarray(x), jnp.asarray(x)))
    for scale in (1.0, 0.5):
        np.testing.assert_allclose(
            tm.bw_median(_t(d2), scale).item(),
            float(jm.bw_median(jnp.asarray(d2), scale)), rtol=1e-6,
        )


def test_grad_gmm_log_p_matches(rng):
    s = rng.normal(size=(12, 5, 3)).astype(np.float32)
    means = rng.normal(size=(12, 15)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(15,)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(12,)).astype(np.float32)
    got = tm.grad_gmm_log_p(_t(s), _t(means), _t(var), _t(w)).numpy()
    want = np.asarray(jm.grad_gmm_log_p(jnp.asarray(s), jnp.asarray(means),
                                        jnp.asarray(var), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_smoothed_box_log_prob_values_and_tie_gradients(rng):
    low = np.array([-2.0, -1.0, 0.5], np.float32)
    high = np.array([2.0, 3.0, 1.5], np.float32)
    x = rng.uniform(-4, 4, size=(20, 3)).astype(np.float32)
    # ties: on the box faces (relu at 0) and at the centre (abs at 0)
    x[0] = low
    x[1] = high
    x[2] = 0.5 * (low + high)

    def tf(v):
        return tm.smoothed_box_log_prob(v, _t(low), _t(high), 0.1)

    def jf(v):
        return jm.smoothed_box_log_prob(v, jnp.asarray(low), jnp.asarray(high), 0.1)

    np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                               rtol=1e-5)
    np.testing.assert_allclose(_tgrad(tf, x), _jgrad(jf, x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["clip", "relu", "abs"])
def test_tie_gradients_match_jax(name):
    x = np.array([-3.0, -2.0, -0.5, 0.0, 0.5, 2.0, 3.0], np.float32)
    tfn, jfn = {
        "clip": (lambda v: tm.clip(v, -2.0, 2.0), lambda v: jnp.clip(v, -2.0, 2.0)),
        "relu": (tm.relu, lambda v: jnp.maximum(v, 0.0)),
        "abs": (tm.jabs, jnp.abs),
    }[name]
    np.testing.assert_array_equal(tfn(_t(x)).numpy(), np.asarray(jfn(jnp.asarray(x))))
    np.testing.assert_array_equal(_tgrad(tfn, x), _jgrad(jfn, x))


def test_box_matches():
    for args in [(3, None, None), (2, -1.0, 2.0), (3, [-1, -2, -3], [1, 2, 3])]:
        tb, jb = Box.create(*args), JBox.create(*args)
        assert (tb.low_t, tb.high_t, tb.bounded) == (jb.low_t, jb.high_t, jb.bounded)
    x = np.array([[-5.0, 0.0, 5.0], [1.0, -2.0, 3.0]], np.float32)
    tb = Box.create(3, [-1, -2, -3], [1, 2, 3])
    jb = JBox.create(3, [-1, -2, -3], [1, 2, 3])
    np.testing.assert_array_equal(tb.clip(_t(x)).numpy(), np.asarray(jb.clip(jnp.asarray(x))))


def test_adam_matches_optax(rng):
    x = rng.normal(size=(6, 4)).astype(np.float32)
    opt = optax.adam(0.1)
    jstate = opt.init(jnp.asarray(x))
    ad = Adam(0.1)
    tstate = ad.init(_t(x))
    jx, tx = jnp.asarray(x), _t(x)
    for _ in range(4):
        g = rng.normal(size=x.shape).astype(np.float32)
        ju, jstate = opt.update(jnp.asarray(g), jstate, jx)
        jx = optax.apply_updates(jx, ju)
        tu, tstate = ad.update(_t(g), tstate)
        tx = tx + tu
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tstate.nu.numpy(), np.asarray(jstate[0].nu), rtol=1e-6)
    assert int(tstate.count) == int(jstate[0].count) == 4


class _TIntegrator(DynamicsModel):
    @property
    def action_space(self):
        return Box.create(2, -1.0, 1.0)

    def step(self, states, actions, params=None):
        return states + tm.clip(actions, -1.0, 1.0) * self.dt


class _JIntegrator(JDynamicsModel):
    @property
    def action_space(self):
        return JBox.create(2, -1.0, 1.0)

    def step(self, states, actions, params=None, key=None):
        return states + jnp.clip(actions, -1.0, 1.0) * self.dt


def test_rollout_and_its_gradient_match(rng):
    s0 = rng.normal(size=(2,)).astype(np.float32)
    acts = rng.uniform(-1.5, 1.5, size=(5, 6, 2)).astype(np.float32)
    acts[0, 0] = 1.0  # a clip tie
    want = np.asarray(jrollout(_JIntegrator(dt=0.1), jnp.asarray(s0), jnp.asarray(acts)))
    got = rollout(_TIntegrator(dt=0.1), _t(s0), _t(acts))
    assert got.shape == (5, 7, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def jf(a):
        return jrollout(_JIntegrator(dt=0.1), jnp.asarray(s0), a) ** 2

    def tf(a):
        return rollout(_TIntegrator(dt=0.1), _t(s0), a) ** 2

    np.testing.assert_allclose(_tgrad(tf, acts), _jgrad(jf, acts), rtol=1e-5, atol=1e-6)


def test_dust_state_from_numpy_roundtrip(rng):
    pol = rng.normal(size=(4, 3, 2)).astype(np.float32)
    st = dust_state_from_numpy(pol, np.ones(4), 3, pol * 0.1, pol ** 2, 5, device="cpu")
    np.testing.assert_array_equal(st.pol_mean.numpy(), pol)
    assert st.svgd_state.opt_state.count.dtype == torch.int32
    assert int(st.svgd_state.step) == 5
    np.testing.assert_array_equal(st.svgd_state.opt_state.nu.numpy(), pol ** 2)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and ``chip_smoke.py``, imports with neither
    JAX nor the JAX package loaded (a subprocess: this test process has
    imported both)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sigsvgd_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'sigsvgd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'sigsvgd_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('sigsvgd_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 16


def test_chip_smoke_fails_without_cuda():
    """Without a card the chip check exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_entry_points_raise_without_cuda():
    """device=None means CUDA; without a card the entry points raise instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
    from sigsvgd_tpu_torch.models.robot.panda import PandaRobot
    from sigsvgd_tpu_torch.models.robot.scene import get_scene

    for fn in (PandaRobot.create, lambda: get_scene("box"), build_arm_mpc):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
