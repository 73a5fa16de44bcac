"""The port's bandwidth rules, scaled and IMQ kernels, ScaledSVGD and
``run_host_loop``, against the JAX package on the same numpy inputs.

Tolerances are those of the JAX tests each check mirrors:

* ``utils/math`` (``tests/test_math.py``): ``scaled_pw_dist_sq`` and its
  ``diff @ M`` at rtol 1e-5 / atol 1e-6 against JAX (both against the
  naive fp64 form at the JAX test's rtol 1e-3 / atol 1e-4);
  ``bw_from_median``, ``bw_median_diff`` and ``bw_silverman`` at rtol
  1e-6; gradients of the two median rules on a symmetric distance matrix
  with a tied median equal to JAX's, element for element (each is one-hot
  on a chosen twin, scaled by the same factor);
* kernels (``tests/test_kernels.py``): K at rtol 1e-5, dK at rtol 1e-4 /
  atol 1e-5, each analytic dK also against autograd of the port's own K;
* ``ScaledSVGD.velocity`` with both ``precondition`` values, a log prior,
  a repulsion schedule and a gradient mask: φ scaled by its max at 1e-5
  (a 12×12 metric solve in fp32), the loss at rtol 1e-6;
* the star-Gaussian run of ``tests/test_svgd.py`` (60 particles, 300 Adam
  steps, MatrixSVGD with ``ScaledGaussianKernel``) from the same numpy
  start: the JAX test's assertions on the port's particles, and the first
  5 steps against JAX's at atol 1e-5;
* ``run_host_loop``: the same particles and state as ``run``, bit for bit,
  and JAX's trace rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigsvgd_tpu.inference import SVGD as JSVGD
from sigsvgd_tpu.inference import ScaledSVGD as JScaledSVGD
from sigsvgd_tpu.inference import ScoreResult as JScoreResult
from sigsvgd_tpu.kernels import IMQKernel as JIMQKernel
from sigsvgd_tpu.kernels import ScaledGaussianKernel as JScaledGaussianKernel
from sigsvgd_tpu.kernels import ScaledIMQKernel as JScaledIMQKernel
from sigsvgd_tpu.models import star_gaussian
from sigsvgd_tpu.utils import math as jm
from sigsvgd_tpu_torch.inference.svgd import (
    SVGD, Adam, ScaledSVGD, ScoreResult, matrix_svgd,
)
from sigsvgd_tpu_torch.kernels.rbf import (
    GaussianKernel, IMQKernel, ScaledGaussianKernel, ScaledIMQKernel,
)
from sigsvgd_tpu_torch.utils import math as tm


def _n(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- utils/math ---------------------------------------------------------------

def test_scaled_pw_dist_sq_matches_jax(rng):
    x = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.standard_normal((5, 4)).astype(np.float32)
    a = rng.standard_normal((4, 4)).astype(np.float32)
    metric = a @ a.T
    d2, dm = tm.scaled_pw_dist_sq(_t(x), _t(y), _t(metric), return_gradient=True)
    d2j, dmj = jm.scaled_pw_dist_sq(jnp.asarray(x), jnp.asarray(y), jnp.asarray(metric),
                                    return_gradient=True)
    np.testing.assert_allclose(d2.numpy(), _n(d2j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dm.numpy(), _n(dmj), rtol=1e-5, atol=1e-6)
    diff = x[:, None].astype(np.float64) - y[None]
    want = np.einsum("nmd,de,nme->nm", diff, metric, diff)
    np.testing.assert_allclose(d2.numpy(), want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(tm.scaled_pw_dist_sq(_t(x), _t(y), _t(metric)).numpy(),
                                  d2.numpy())


def _tied_distances(rng):
    """A symmetric [8, 8] squared-distance matrix whose lower median
    appears twice (``d2[i, j] = d2[j, i]``)."""
    p = rng.standard_normal((8, 3)).astype(np.float32)
    d2 = np.asarray(jm.pw_dist_sq(jnp.asarray(p), jnp.asarray(p)))
    d2 = 0.5 * (d2 + d2.T)
    flat = d2.reshape(-1)
    med = np.sort(flat)[(flat.size - 1) // 2]
    assert (flat == med).sum() == 2
    return d2


@pytest.mark.parametrize("rule", ["bw_median", "bw_median_diff"])
def test_median_bandwidth_gradients_match_jax_on_a_tied_median(rng, rule):
    d2 = _tied_distances(rng)
    h_j, g_j = jax.value_and_grad(lambda d: getattr(jm, rule)(d, 1.3))(jnp.asarray(d2))
    x = _t(d2).requires_grad_(True)
    h = getattr(tm, rule)(x, 1.3)
    (g,) = torch.autograd.grad(h, x)
    np.testing.assert_allclose(float(h.detach()), float(h_j), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), _n(g_j), rtol=1e-6, atol=0)
    assert (g.numpy() != 0).sum() == 1
    if rule == "bw_median_diff":       # the first twin in row-major order
        flat = d2.reshape(-1)
        first = int(np.argmax(flat == np.sort(flat)[(flat.size - 1) // 2]))
        assert g.numpy().reshape(-1)[first] != 0
    with torch.no_grad():
        np.testing.assert_array_equal(float(getattr(tm, rule)(_t(d2), 1.3)), float(h))


def test_bw_from_median_matches_jax():
    for med, n in ((0.37, 10), (2.5, 1024), (0.0, 4)):
        np.testing.assert_allclose(
            float(tm.bw_from_median(torch.tensor(med), n, 0.7)),
            float(jm.bw_from_median(jnp.float32(med), n, 0.7)), rtol=1e-6)


@pytest.mark.parametrize("spread", ["iqr", "std"])
def test_bw_silverman_matches_jax(rng, spread):
    if spread == "iqr":    # heavy tails: IQR/1.349 below every column's std
        x = rng.laplace(size=(200, 3)).astype(np.float32)
    else:                  # one narrow column: the per-column std
        x = rng.standard_normal((40, 3)).astype(np.float32) * np.array([1.0, 1.0, 0.05],
                                                                         np.float32)
    got = tm.bw_silverman(_t(x), 1.2).numpy()
    want = _n(jm.bw_silverman(jnp.asarray(x), 1.2))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    iqr = np.subtract(*np.percentile(x, [75, 25])) / 1.349
    assert (iqr < x.std(0, ddof=1).min()) == (spread == "iqr")


# -- kernels/rbf --------------------------------------------------------------

def _autograd_dk(kern, x, **kw):
    """``Σ_j ∂k(x_i, x_j)/∂x_i`` with the second argument held fixed."""
    xx = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(kern(xx, x, compute_grad=False, **kw).sum(), xx)
    return g


KERNELS = {
    "scaled_gaussian": (ScaledGaussianKernel, JScaledGaussianKernel, True),
    "imq": (IMQKernel, JIMQKernel, False),
    "scaled_imq": (ScaledIMQKernel, JScaledIMQKernel, True),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernels_match_jax(rng, name):
    tcls, jcls, scaled = KERNELS[name]
    x = rng.standard_normal((5, 3)).astype(np.float32)
    y = rng.standard_normal((4, 3)).astype(np.float32)
    a = rng.standard_normal((3, 3)).astype(np.float32)
    metric = a @ a.T + np.eye(3, dtype=np.float32) + 0.3 * a   # not symmetric
    kws = [dict(h=1.1), {}] + ([dict(M=metric, h=1.1), dict(M=metric)] if scaled else [])
    for kw in kws:
        tkw = {k: (_t(v) if k == "M" else v) for k, v in kw.items()}
        jkw = {k: (jnp.asarray(v) if k == "M" else v) for k, v in kw.items()}
        K, dK = tcls()(_t(x), _t(y), **tkw)
        Kj, dKj = jcls()(jnp.asarray(x), jnp.asarray(y), **jkw)
        np.testing.assert_allclose(K.numpy(), _n(Kj), rtol=1e-5)
        np.testing.assert_allclose(dK.numpy(), _n(dKj), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(
            tcls()(_t(x), _t(y), compute_grad=False, **tkw).numpy(), K.numpy())
        if "h" in kw:   # the analytic gradient: K's derivative at a fixed h
            _, dKs = tcls()(_t(x), _t(x), **tkw)
            np.testing.assert_allclose(dKs.numpy(),
                                       _autograd_dk(tcls(), _t(x), **tkw).numpy(),
                                       rtol=1e-4, atol=1e-5)
    if scaled:     # the identity metric: the plain kernel
        plain = GaussianKernel() if name == "scaled_gaussian" else IMQKernel()
        K, dK = tcls()(_t(x), _t(x), M=torch.eye(3), h=0.9)
        Kp, dKp = plain(_t(x), _t(x), h=0.9)
        np.testing.assert_allclose(K.numpy(), Kp.numpy(), rtol=1e-5)
        np.testing.assert_allclose(dK.numpy(), dKp.numpy(), rtol=1e-4, atol=1e-5)
    # analytic_grad=False is accepted and not read, as in the JAX package
    np.testing.assert_array_equal(tcls(analytic_grad=False)(_t(x), _t(y), h=1.1)[1].numpy(),
                                  tcls()(_t(x), _t(y), h=1.1)[1].numpy())


# -- inference/svgd: ScaledSVGD -----------------------------------------------

def _box_log_prior(xp):
    def log_prior(x):
        return -0.5 * ((x - 0.3) ** 2).reshape(x.shape[0], -1).sum(-1)
    return log_prior


@pytest.mark.parametrize("precondition", [True, False])
def test_scaled_svgd_velocity_matches_jax(rng, precondition):
    x = rng.standard_normal((9, 4, 3)).astype(np.float32)
    s = rng.standard_normal((9, 4, 3)).astype(np.float32)
    mask = np.ones((9, 4, 3), np.float32)
    mask[:2] = 0.0
    for prior, sched, m in ((None, None, None), (True, True, mask)):
        common = dict(precondition=precondition)
        jsv = JScaledSVGD(kernel=JScaledGaussianKernel(),
                          log_prior=_box_log_prior(jnp) if prior else None,
                          repulsion_schedule=(lambda t: 0.5 + 0.1 * t) if sched else None,
                          gradient_mask=None if m is None else jnp.asarray(m), **common)
        tsv = ScaledSVGD(kernel=ScaledGaussianKernel(),
                         log_prior=_box_log_prior(torch) if prior else None,
                         repulsion_schedule=(lambda t: 0.5 + 0.1 * t) if sched else None,
                         gradient_mask=None if m is None else _t(m), **common)
        phi_j, loss_j = jsv.velocity(jnp.asarray(x), JScoreResult(grad_log_p=jnp.asarray(s)),
                                     jnp.asarray(2))
        phi, loss = tsv.velocity(_t(x), ScoreResult(grad_log_p=_t(s)), torch.tensor(2))
        scale = np.abs(_n(phi_j)).max()
        np.testing.assert_allclose(phi.numpy() / scale, _n(phi_j) / scale, atol=1e-5)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
        if m is not None:
            assert not phi[:2].any()
    # the score's kernel terms are not read, as in the JAX package
    score = ScoreResult(grad_log_p=_t(s), k_xx=torch.zeros(9, 9), grad_k=torch.ones(9, 12))
    np.testing.assert_array_equal(
        tsv.velocity(_t(x), score, torch.tensor(2))[0].numpy(),
        tsv.velocity(_t(x), ScoreResult(grad_log_p=_t(s)), torch.tensor(2))[0].numpy())
    with pytest.raises(NotImplementedError, match="GaussNewton"):
        ScaledSVGD(metric="Fisher").velocity(_t(x), score, 0)
    assert matrix_svgd().precondition and isinstance(matrix_svgd().kernel,
                                                     ScaledGaussianKernel)


def test_scaled_svgd_star_gaussian_run():
    """``tests/test_svgd.py::test_scaled_svgd_star_gaussian`` from numpy
    particles, the target's score taken from the JAX model."""
    target = star_gaussian(skewness=10.0, n_components=5)
    x0 = (np.random.default_rng(3).standard_normal((60, 2)) * 0.3).astype(np.float32)
    grad = jax.jit(target.grad_log_p)

    def tscore(x, _g):
        return ScoreResult(grad_log_p=_t(np.array(grad(jnp.asarray(x.numpy())))))

    def jscore(x, _k):
        return JScoreResult(grad_log_p=target.grad_log_p(x), loss=-target.logp(x))

    xf, _, data = matrix_svgd(optimizer=Adam(0.05)).run(_t(x0), tscore, 300)
    radii = torch.linalg.norm(xf, dim=-1)
    assert 1.0 < float(radii.mean()) < 2.2
    assert torch.isfinite(xf).all()
    jsv = JScaledSVGD(kernel=JScaledGaussianKernel(), optimizer=optax.adam(0.05),
                      precondition=True)
    _, _, jdata = jax.jit(lambda x: jsv.run(x, jscore, 5))(jnp.asarray(x0))
    np.testing.assert_allclose(data.trace[:6].numpy(), _n(jdata.trace), atol=1e-5)


@pytest.mark.parametrize("trace_every", [0, 2, 3])
def test_run_host_loop_equals_run(rng, trace_every):
    x0 = _t(rng.standard_normal((7, 3)).astype(np.float32))

    def score_fn(x, _g):
        return ScoreResult(grad_log_p=-x, loss=(x * x).sum(-1))

    for sampler in (SVGD(kernel=GaussianKernel(), optimizer=Adam(0.1)),
                    ScaledSVGD(kernel=ScaledGaussianKernel(), lr=0.05),
                    SVGD(adagrad=True, lr=0.2)):
        xr, sr, dr = sampler.run(x0, score_fn, 6)
        xh, sh, dh = sampler.run_host_loop(x0, score_fn, 6, trace_every=trace_every)
        assert torch.equal(xr, xh) and int(sr.step) == int(sh.step) == 6
        for a, b in zip(jax.tree_util.tree_leaves(tuple(sr.opt_state)),
                        jax.tree_util.tree_leaves(tuple(sh.opt_state))):
            assert torch.equal(a, b)
        steps = {0: [0, 6], 2: [0, 2, 4, 6], 3: [0, 3, 6]}[trace_every]
        assert torch.equal(dh.trace, dr.trace[steps])
        assert torch.equal(dh.loss, torch.stack([(x * x).sum(-1) for x in dr.trace[:-1]]))
        assert dh.aux is None
    # trace_every not dividing n_steps: the final particles close the trace
    _, _, d5 = SVGD(lr=0.1).run_host_loop(x0, score_fn, 5, trace_every=2)
    assert d5.trace.shape[0] == 4
    _, _, dz = SVGD(lr=0.1).run_host_loop(x0, lambda x, g: ScoreResult(grad_log_p=-x), 2)
    assert torch.equal(dz.loss, torch.zeros(2))
    with pytest.raises(NotImplementedError, match="M10"):
        SVGD().run_host_loop(x0, score_fn, 1, value_fn=lambda x: x)


def test_run_host_loop_matches_jax_trace_rule(rng):
    """JAX's ``run_host_loop`` on the same particles and score: its trace
    indices and the final particles (raw lr update, rtol 1e-5)."""
    x0 = rng.standard_normal((6, 2)).astype(np.float32)

    def jscore(x, _k):
        return JScoreResult(grad_log_p=-x, loss=jnp.sum(x * x, -1))

    def tscore(x, _g):
        return ScoreResult(grad_log_p=-x, loss=(x * x).sum(-1))

    xj, _, dj = JSVGD(lr=0.1).run_host_loop(jnp.asarray(x0), jscore, 5, trace_every=2)
    xt, _, dt = SVGD(lr=0.1).run_host_loop(_t(x0), tscore, 5, trace_every=2)
    assert dt.trace.shape == dj.trace.shape and dt.loss.shape == dj.loss.shape
    np.testing.assert_allclose(dt.trace.numpy(), _n(dj.trace), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.numpy(), _n(xj), rtol=1e-5, atol=1e-6)
