"""The port's planning path against the JAX package on the CPU.

Splines and schedulers, the planning cost and its gradient, the order-6
signature kernel's Gram and repulsion gradient, the scheduled Stein
velocity, chained ``run_optimisation`` for ``pathsig`` (depth 6, fp32
"highest"), ``svgd`` and ``sgd`` from the same numpy ``x0``, and
``evaluate_trajectory``. Tolerances: rtol 1e-5 for splines and schedules,
scaled atol 1e-5/1e-4 for the Gram and its gradient (fp32 against fp32),
scaled atol 1e-4 for the cost gradient, and rtol 1e-4, atol 1e-5 for the
chained runs (``tests/test_planning.py``'s
resume check).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import planning as jplan
from sigsvgd_tpu.inference.svgd import SVGD as JSVGD
from sigsvgd_tpu.inference.svgd import ScoreResult as JScoreResult
from sigsvgd_tpu.kernels.sigkernel import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.models.robot import PandaRobot as JPandaRobot
from sigsvgd_tpu.models.robot.scene import get_scene as j_get_scene
from sigsvgd_tpu.utils import schedulers as jsched
from sigsvgd_tpu.utils import splines as jspl
from sigsvgd_tpu.utils.math import smoothed_box_log_prob as j_box
from sigsvgd_tpu_torch.experiments import planning as tplan
from sigsvgd_tpu_torch.experiments.arm_mpc import (
    Q_START, Q_TARGET, build_arm_mpc, build_planning_problem,
)
from sigsvgd_tpu_torch.inference.score import pathsig_score
from sigsvgd_tpu_torch.inference.svgd import SVGD, ScoreResult
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel
from sigsvgd_tpu_torch.kernels.signature import PathSigKernel
from sigsvgd_tpu_torch.utils import schedulers, splines
from sigsvgd_tpu_torch.utils.math import smoothed_box_log_prob

T, BODY = 50, 5


def _n(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def problems():
    jp = jplan.PlanningProblem(
        robot=JPandaRobot.create(),
        q_start=jnp.asarray(Q_START, jnp.float32),
        q_target=jnp.asarray(Q_TARGET, jnp.float32),
        occupancy_fn=jplan.sdf_occupancy(j_get_scene("bookshelf_small")),
        timesteps=T, n_body_points=BODY,
    )
    tp = build_planning_problem(device="cpu", timesteps=T, n_body_points=BODY)
    return jp, tp


def _knots(rng, tp, batch):
    lower, upper = (t.numpy() for t in tp.robot.joint_limits())
    u = rng.uniform(size=(batch, 3, 7)).astype(np.float32)
    return (lower + (upper - lower) * u).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 5, 9])
def test_splines_match_jax(rng, n):
    t = np.sort(rng.uniform(0, 1, size=n)).astype(np.float32)
    t[0], t[-1] = 0.0, 1.0
    y = rng.normal(size=(4, n, 3)).astype(np.float32)
    tq = np.linspace(0.0, 1.0, 37).astype(np.float32)
    js = jspl.natural_cubic_spline_coeffs(jnp.asarray(t), jnp.asarray(y))
    ts = splines.natural_cubic_spline_coeffs(torch.from_numpy(t), torch.from_numpy(y))
    for a, b in zip(ts[1:], js[1:]):
        np.testing.assert_allclose(a.numpy(), _n(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(splines.spline_evaluate(ts, torch.from_numpy(tq)).numpy(),
                               _n(jspl.spline_evaluate(js, jnp.asarray(tq))),
                               rtol=1e-5, atol=1e-6)
    for order in (1, 2):
        np.testing.assert_allclose(
            splines.spline_derivative(ts, torch.from_numpy(tq), order).numpy(),
            _n(jspl.spline_derivative(js, jnp.asarray(tq), order)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        splines.spline_trajectory(torch.from_numpy(y), 200).numpy(),
        _n(jspl.spline_trajectory(jnp.asarray(y), 200)), rtol=1e-5, atol=1e-6)


def test_schedulers_match_jax():
    steps = np.arange(0, 601)
    pairs = [
        (schedulers.cosine(1.0, 0.0, 375, 125), jsched.cosine(1.0, 0.0, 375, 125)),
        (schedulers.cosine(2.0, 0.5, 300), jsched.cosine(2.0, 0.5, 300)),
        (schedulers.square_root(0.7), jsched.square_root(0.7)),
        (schedulers.factor(1.0, 0.99, 1e-3), jsched.factor(1.0, 0.99, 1e-3)),
        (schedulers.constant(0.3), jsched.constant(0.3)),
    ]
    for ts, js in pairs:
        got = np.broadcast_to(ts(torch.from_numpy(steps).to(torch.int32)).numpy(),
                              steps.shape)
        want = np.broadcast_to(_n(js(jnp.asarray(steps, jnp.int32))), steps.shape)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        for s in (0, 125, 376):  # a 0-d step, as the sampler passes it
            np.testing.assert_allclose(float(ts(torch.tensor(s, dtype=torch.int32))),
                                       float(js(jnp.asarray(s, jnp.int32))), rtol=1e-5)


def test_batch_cost_and_gradient_match_jax(rng, problems):
    jp, tp = problems
    x = _knots(rng, tp, 4)
    def total(xx):
        cost, aux = jp.batch_cost(xx)
        return jnp.sum(cost), (cost, aux)

    (_, (cj, auxj)), gj = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ct, auxt = tp.batch_cost(xt)
    (gt,) = torch.autograd.grad(ct.sum(), xt)
    np.testing.assert_allclose(ct.detach().numpy(), _n(cj), rtol=1e-5)
    for k in auxj:
        np.testing.assert_allclose(auxt[k].detach().numpy(), _n(auxj[k]),
                                   rtol=1e-5, atol=1e-6)
    # scaled 1e-4, as the signature gradients: the cost sums 50 steps of 45
    # sharp (sigmoid(-50·sdf)) occupancies in another order than XLA
    s = np.abs(_n(gj)).max()
    np.testing.assert_allclose(gt.numpy() / s, _n(gj) / s, atol=1e-4)


def test_depth6_gram_and_grad_matches_jax(rng):
    X = (rng.normal(size=(16, 3, 7)) * 0.5).astype(np.float32)
    K, dX = SignatureKernel(6, 1.5, mxu_precision="highest").gram_and_grad(
        torch.from_numpy(X))
    Kj, dXj = JSignatureKernel(dyadic_order=6, bandwidth=1.5,
                               mxu_precision="highest").gram_and_grad(jnp.asarray(X))
    sk, sd = np.abs(_n(Kj)).max(), np.abs(_n(dXj)).max()
    np.testing.assert_allclose(K.numpy() / sk, _n(Kj) / sk, atol=1e-5)
    np.testing.assert_allclose(dX.numpy() / sd, _n(dXj) / sd, atol=1e-4)


def test_scheduled_velocity_matches_jax(rng, problems):
    _, tp = problems
    lower, upper = tp.robot.joint_limits()
    x = _knots(rng, tp, 6)
    s = rng.normal(size=x.shape).astype(np.float32)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    k = (a @ a.T / 6).astype(np.float32)
    gk = rng.normal(size=x.shape).astype(np.float32)
    loss = rng.uniform(size=6).astype(np.float32)
    jl, ju = jnp.asarray(lower.numpy()), jnp.asarray(upper.numpy())
    jsv = JSVGD(lr=1e-3, log_prior=lambda xx: j_box(xx, jl, ju, 0.1).sum(-1),
                repulsion_schedule=jsched.cosine(1.0, 0.0, 375, 125))
    tsv = SVGD(lr=1e-3, log_prior=lambda xx: smoothed_box_log_prob(
        xx, lower, upper, 0.1).sum(-1), repulsion_schedule=schedulers.cosine(
            1.0, 0.0, 375, 125))
    js = JScoreResult(jnp.asarray(s), jnp.asarray(k), jnp.asarray(gk), jnp.asarray(loss))
    ts = ScoreResult(torch.from_numpy(s), torch.from_numpy(k), torch.from_numpy(gk),
                     torch.from_numpy(loss))
    for step in (0, 200, 450):
        pj, lj = jsv.velocity(jnp.asarray(x), js, jnp.asarray(step, jnp.int32))
        pt, lt = tsv.velocity(torch.from_numpy(x), ts, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(pt.numpy(), _n(pj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lt.numpy(), _n(lj))


@pytest.mark.parametrize("method", ["pathsig", "svgd", "sgd"])
def test_chained_run_optimisation_matches_jax(rng, problems, method):
    jp, tp = problems
    x0 = _knots(rng, tp, 6)
    cfg = dict(method=method, n_iter=5, batch=6, timesteps=T, mxu_precision="highest")
    xj, dj = jplan.run_optimisation(jp, jplan.PlannerConfig(**cfg), jax.random.PRNGKey(0),
                                    x0=jnp.asarray(x0))
    xt, dt = tplan.run_optimisation(tp, tplan.PlannerConfig(**cfg), x0=torch.from_numpy(x0))
    np.testing.assert_allclose(xt.numpy(), _n(xj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dt.loss.numpy(), _n(dj.loss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dt.trace.numpy(), _n(dj.trace), rtol=1e-4, atol=1e-5)
    assert dt.trace.shape == (6, 6, 3, 7)
    for k in dj.aux:
        np.testing.assert_allclose(dt.aux[k].numpy(), _n(dj.aux[k]), rtol=1e-4, atol=1e-5)


def test_evaluate_trajectory_matches_jax(rng, problems):
    jp, tp = problems
    x = _knots(rng, tp, 5)
    want = jplan.evaluate_trajectory(jp, jnp.asarray(x), threshold=0.2)
    got = tplan.evaluate_trajectory(tp, torch.from_numpy(x), threshold=0.2)
    for k in ("max_occ", "max_self_collision", "ee_path_length"):
        np.testing.assert_allclose(got[k].numpy(), _n(want[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["success"].numpy(), _n(want["success"]))


def test_gram_above_the_dense_limit_raises(rng, monkeypatch):
    """Above the dense limit the JAX package streams the Gram by pair chunks
    with a bandwidth from the first 256×256 block; at λ=0 those chunks take
    the λ=0 pair list (K7), which the port now has. On planning knot paths
    [n, 3, 7] under a lowered ``_DENSE_LIMIT`` the streamed Gram and its
    gradient match JAX's ``solver="pallas_small"`` (K rtol 3e-5 / atol 2e-5,
    dX scaled 5e-5, ``tests/test_pallas_small.py``); where the pair list
    takes no shape (C > 8) both packages take the wavefront, held the same
    way."""
    for cls in (SignatureKernel, JSignatureKernel):
        monkeypatch.setattr(cls, "_DENSE_LIMIT", 100)
    X = rng.uniform(-2.0, 2.0, size=(6, 3, 7)).astype(np.float32)
    Y = rng.uniform(-2.0, 2.0, size=(5, 3, 7)).astype(np.float32)
    assert 6 * 5 * 3 * 3 > SignatureKernel._DENSE_LIMIT
    jk = JSignatureKernel(dyadic_order=0, bandwidth=None, solver="pallas_small")
    Kj, vjp = jax.vjp(lambda x: jk.gram(x, jnp.asarray(Y)), jnp.asarray(X))
    (dXj,) = vjp(jnp.ones_like(Kj))
    x = torch.from_numpy(X).requires_grad_(True)
    K = SignatureKernel(dyadic_order=0, bandwidth=None).gram(x, torch.from_numpy(Y))
    (dX,) = torch.autograd.grad(K.sum(), x)
    np.testing.assert_allclose(K.detach().numpy(), _n(Kj), rtol=3e-5, atol=2e-5)
    scale = float(np.abs(_n(dXj)).max())
    np.testing.assert_allclose(dX.numpy() / scale, _n(dXj) / scale, atol=5e-5)
    X9 = rng.uniform(-2.0, 2.0, size=(6, 3, 9)).astype(np.float32)
    Y9 = rng.uniform(-2.0, 2.0, size=(5, 3, 9)).astype(np.float32)
    Kj = jk.gram(jnp.asarray(X9), jnp.asarray(Y9))
    K = SignatureKernel(dyadic_order=0, bandwidth=None).gram(torch.from_numpy(X9),
                                                            torch.from_numpy(Y9))
    np.testing.assert_allclose(K.numpy(), _n(Kj), rtol=3e-5, atol=2e-5)


def test_unported_planner_options_raise(problems):
    _, tp = problems
    with pytest.raises(NotImplementedError, match="M10"):
        tplan.run_optimisation(tp, tplan.PlannerConfig(optimizer="lbfgs", n_iter=1))
    with pytest.raises(NotImplementedError, match="M14"):
        tplan.run_optimisation(tp, tplan.PlannerConfig(n_iter=1), checkpoint_dir="x")
    # the truncated-signature kernel is ported: pathsig_score takes it
    assert callable(pathsig_score(tp.batch_cost, PathSigKernel(depth=2)))
    # SVGD's Adagrad and the scaled samplers are ported
    matrix = dataclasses.replace(
        build_arm_mpc(device="cpu", n_pol=2, hz_len=2, kernel_mode="policy").ctrl,
        stein_sampler="MatrixSVGD")
    assert matrix._sampler().precondition
    with pytest.raises(NotImplementedError, match="M10"):
        SVGD().run(torch.zeros(2, 3), lambda x, g: None, 1, value_fn=lambda x: x)
