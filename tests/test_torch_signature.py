"""The port's truncated signature, ``PathSigKernel`` and the obstacle-field
planner against the JAX package on the CPU.

``signature`` and ``batch_signature`` at depths 1-4 on C = 2 and 3: in fp64
bit for bit against JAX's ops run one by one (``jax.disable_jit``: the same
Chen order), and rtol 1e-12 with atol 1e-15 against the jitted transform
(XLA fuses products into sums, which moves a few entries by an ulp of the
largest, relatively more on entries that cancel); fp32 rtol 1e-5;
the linear-path closed form; ``PathSigKernel``'s K atol 1e-5 and dK
against ``jax.value_and_grad`` rtol 1e-4; ``pathsig_score`` with it;
``halton``, the field's cost (the spline paths atol 1e-5, a few fp32 ulps
of their size 4); and 5 iterations of ``obstacle_field.run`` for
``pathsig`` (the order-3 ``SignatureKernel``, K2's twin here), ``svgd`` and
``sgd`` from JAX's initial knots at ``run``'s default ``lr`` 0.02: the paths
(through the final knots) atol 1e-4 (``tests/test_experiments.py``'s
obstacle-field runs, shortened). At ``lr`` 0.05 the pathsig run amplifies
the two packages' first-step difference (5e-6) about eightfold a step, its
mean cost oscillating, and 5 steps end 6.7e-3 apart.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.experiments import obstacle_field as jof
from sigsvgd_tpu.inference.score import pathsig_score as j_pathsig_score
from sigsvgd_tpu_torch.experiments import obstacle_field as tof
from sigsvgd_tpu_torch.inference.score import pathsig_score
from sigsvgd_tpu_torch.kernels import signature as tsig

# the package's ``kernels`` namespace exports the function ``signature``
jsig = importlib.import_module("sigsvgd_tpu.kernels.signature")


def _n(a):
    return np.asarray(a)


@pytest.mark.parametrize("C", [2, 3])
def test_signature_matches_jax_in_fp64(C):
    paths = np.random.default_rng(C).standard_normal((3, 6, C)) * 0.5
    for depth in (1, 2, 3, 4):
        for basepoint in (True, False):
            with jax.enable_x64(True):
                want = _n(jsig.batch_signature(jnp.asarray(paths), depth, basepoint))
                with jax.disable_jit():
                    eager = _n(jsig.batch_signature(jnp.asarray(paths), depth, basepoint))
            assert want.dtype == np.float64
            got = tsig.batch_signature(torch.from_numpy(paths), depth, basepoint).numpy()
            assert got.shape == (3, tsig.sig_dim(C, depth))
            np.testing.assert_array_equal(got, eager)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        one = tsig.signature(torch.from_numpy(paths[1]), depth).numpy()
        with jax.enable_x64(True), jax.disable_jit():
            want = _n(jsig.signature(jnp.asarray(paths[1]), depth))
        np.testing.assert_array_equal(one, want)


@pytest.mark.parametrize("C", [2, 3])
def test_signature_matches_jax_in_fp32(C):
    paths = (np.random.default_rng(10 + C).standard_normal((2, 4, 7, C)) * 0.5).astype(
        np.float32)
    for depth in (1, 2, 3, 4):
        want = _n(jsig.batch_signature(jnp.asarray(paths), depth))
        got = tsig.batch_signature(torch.from_numpy(paths), depth).numpy()
        assert got.shape == (2, 4, tsig.sig_dim(C, depth))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="single path"):
        tsig.signature(torch.from_numpy(paths), 2)


def test_signature_linear_path_closed_form():
    """For a single straight segment, level k = Δ^{⊗k}/k!."""
    delta = np.array([0.3, -0.7], np.float32)
    path = torch.from_numpy(np.stack([np.zeros(2, np.float32), delta]))
    got = tsig.signature(path, depth=3, basepoint=False).numpy()
    want = np.concatenate([delta, np.outer(delta, delta).reshape(-1) / 2,
                           np.einsum("i,j,k->ijk", delta, delta, delta).reshape(-1)
                           / math.factorial(3)])
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("h", [2.0, None])
def test_pathsig_kernel_matches_jax(h):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((6, 8, 2)).astype(np.float32)
    Y = rng.standard_normal((5, 8, 2)).astype(np.float32)
    jk, tk = jsig.PathSigKernel(depth=3), tsig.PathSigKernel(depth=3)
    Kj, dKj = jk(jnp.asarray(X), jnp.asarray(Y), h=h)
    K, dK = tk(torch.from_numpy(X), torch.from_numpy(Y), h=h)
    np.testing.assert_allclose(K.numpy(), _n(Kj), atol=1e-5)
    np.testing.assert_allclose(dK.numpy(), _n(dKj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tk(torch.from_numpy(X), torch.from_numpy(X), h=h,
                                  compute_grad=False).diagonal().numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(tk.gram(torch.from_numpy(X), torch.from_numpy(Y), h=h).numpy(),
                               _n(jk.gram(jnp.asarray(X), jnp.asarray(Y), h=h)), atol=1e-5)


def test_pathsig_score_takes_pathsig_kernel():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 4, 2)).astype(np.float32)

    def cost_j(p):
        return jnp.sum(p ** 2, axis=(1, 2)), None

    def cost_t(p):
        return torch.sum(p ** 2, dim=(1, 2)), None

    sj = j_pathsig_score(cost_j, jsig.PathSigKernel(depth=2))(jnp.asarray(x), None)
    st = pathsig_score(cost_t, tsig.PathSigKernel(depth=2))(torch.from_numpy(x), None)
    np.testing.assert_allclose(st.grad_log_p.numpy(), _n(sj.grad_log_p), rtol=1e-6)
    np.testing.assert_allclose(st.k_xx.numpy(), _n(sj.k_xx), atol=1e-5)
    np.testing.assert_allclose(st.grad_k.numpy(), _n(sj.grad_k), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st.loss.numpy(), _n(sj.loss), rtol=1e-6)


def test_halton_and_field_match_jax():
    for base in (2, 3, 5):
        np.testing.assert_array_equal(tof.halton(50, base), jof.halton(50, base))
    np.testing.assert_allclose(tof.halton(4, 2), [0.5, 0.25, 0.75, 0.125])
    assert tof.ObstacleField.create() == tof.ObstacleField(jof.ObstacleField.create().centers)
    x = np.random.default_rng(2).uniform(-4, 4, size=(3, 4, 2)).astype(np.float32)
    cj, aj = jof.FieldProblem(jof.ObstacleField.create()).batch_cost(jnp.asarray(x))
    ct, at = tof.FieldProblem(tof.ObstacleField.create()).batch_cost(torch.from_numpy(x))
    np.testing.assert_allclose(ct.numpy(), _n(cj), rtol=1e-5)
    np.testing.assert_allclose(at["paths"].numpy(), _n(aj["paths"]), atol=1e-5)


@pytest.mark.parametrize("method", ["pathsig", "svgd", "sgd"])
def test_obstacle_field_run_matches_jax(method):
    """5 iterations from JAX's initial knots (``run``'s own draw for seed 0):
    the final knots (through the cost's paths) atol 1e-4, the costs rtol 1e-4."""
    kw = dict(method=method, n_iter=5, batch=6, n_free_knots=4, lr=0.02, seed=0)
    x0 = _n(jax.random.uniform(jax.random.PRNGKey(0), (6, 4, 2), minval=-4.0, maxval=4.0))
    want = jof.run(**kw)
    got = tof.run(**kw, device="cpu", x0=torch.from_numpy(x0.copy()))
    np.testing.assert_allclose(got["paths"], want["paths"], atol=1e-4)
    np.testing.assert_allclose(got["final_costs"], want["final_costs"], rtol=1e-4)
    assert got["paths"].shape == (6, 100, 2)
    np.testing.assert_allclose(got["best_cost"], want["best_cost"], rtol=1e-4)
