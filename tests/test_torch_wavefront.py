"""The port's wavefront Goursat solve and the ``SignatureKernel`` routes
that take it, against the JAX package on the same numpy inputs.

Solver (the checks and tolerances of ``tests/test_sigkernel.py``):

* values: :func:`solve_goursat_pde` against JAX's
  ``solve_goursat_pde_scan`` at λ = 0, 1, 2 on ``[5, 4, 4]``, rtol 1e-6
  (each node is the fused ``fma(left + up, A, -(corner·B))`` XLA makes of
  the JAX step, so they agree to the bit here), and bit for bit against
  the port's own scan oracle; against the naive fp64 solver of
  ``tests/test_sigkernel.py`` at its rtol 1e-4 / atol 1e-5;
* the adjoint: against JAX's custom VJP and its scan AD at rtol 1e-4 /
  atol 1e-5, and against autograd through the port's scan oracle in fp64
  at 1e-12 (the port's adjoint recomputes each segment's diagonals from
  its checkpoint: it is exact);
* rectangular ``[7, 3, 5]`` at λ=1 in chunks of 3, as JAX's test;
* one mid-size grid, L = 12 at λ=2 (a 44×44 fine grid, two checkpoint
  segments), the gradient scaled by its max at atol 5e-4, the tolerance of
  JAX's large-grid test.

``SignatureKernel`` (``gram``, ``gram_sym``, ``gram_and_grad``) at λ = 1
and 2, at λ=0 with linear statics, at λ=0 with C = 9 (beyond K7) and at
``solver="wavefront"`` (λ=3), against the JAX kernel: K at rtol 1e-5 /
atol 3e-5 (the two packages' statics round apart; each is 2e-5 from fp64
at K ≈ 3.6 on these paths), the gradients scaled by their max at 5e-5.
Linear statics take paths scaled by 0.3: on larger ones (K ≈ 150) JAX's
reconstruct-in-reverse adjoint drifts by 1e-3 of the gradient's max while
the port's stays at 4e-7 of fp64 (a reference behaviour, ROADMAP.md).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.kernels.sigkernel import solve_goursat_pde as j_solve
from sigsvgd_tpu.kernels.sigkernel import solve_goursat_pde_scan as j_scan
from sigsvgd_tpu_torch.kernels import sigkernel as sk
from sigsvgd_tpu_torch.kernels.sigkernel import (
    SignatureKernel, solve_goursat_pde, solve_goursat_pde_scan,
)


def _n(a):
    return np.asarray(a)


def _naive_pde(inc, lam):
    """fp64 row-major solver of ``tests/test_sigkernel.py``."""
    inc = np.asarray(inc, np.float64) / 4.0**lam
    lx, ly = inc.shape
    gx, gy = lx * 2**lam, ly * 2**lam
    k = np.ones((gx + 1, gy + 1))
    for i in range(1, gx + 1):
        for j in range(1, gy + 1):
            z = inc[(i - 1) >> lam, (j - 1) >> lam]
            k[i, j] = ((k[i, j - 1] + k[i - 1, j]) * (1 + 0.5 * z + z * z / 12)
                       - k[i - 1, j - 1] * (1 - z * z / 12))
    return k[gx, gy]


def _port_vjp(inc, g, lam, chunk=None, solve=solve_goursat_pde):
    x = torch.from_numpy(inc).requires_grad_(True)
    k = solve(x, lam) if chunk is None else solve(x, lam, chunk)
    (d,) = torch.autograd.grad(k, x, torch.from_numpy(g))
    return k.detach().numpy(), d.numpy()


def _jax_vjp(fn, inc, g):
    k, vjp = jax.vjp(fn, jnp.asarray(inc))
    (d,) = vjp(jnp.asarray(g))
    return _n(k), _n(d)


@pytest.mark.parametrize("lam", [0, 1, 2])
def test_wavefront_values_and_adjoint_match_jax(rng, lam):
    inc = (rng.standard_normal((5, 4, 4)) * 0.2).astype(np.float32)
    g = rng.standard_normal(5).astype(np.float32)
    k, d = _port_vjp(inc, g, lam)
    k_scan, d_scan = _jax_vjp(lambda z: j_scan(z, lam), inc, g)
    _, d_prod = _jax_vjp(lambda z: j_solve(z, lam), inc, g)
    np.testing.assert_allclose(k, k_scan, rtol=1e-6)
    np.testing.assert_array_equal(
        k, solve_goursat_pde_scan(torch.from_numpy(inc), lam).numpy())
    for want in (d_scan, d_prod):
        np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-5)
    want = np.array([_naive_pde(inc[b], lam) for b in range(5)])
    np.testing.assert_allclose(k, want, rtol=1e-4, atol=1e-5)
    # in fp64 the adjoint is autograd's through the scan oracle
    k64, d64 = _port_vjp(inc.astype(np.float64), g.astype(np.float64), lam)
    ks64, ds64 = _port_vjp(inc.astype(np.float64), g.astype(np.float64), lam,
                           solve=solve_goursat_pde_scan)
    np.testing.assert_array_equal(k64, ks64)
    np.testing.assert_allclose(d64, ds64, rtol=0, atol=1e-12)


def test_wavefront_rectangular_and_chunked(rng):
    inc = (rng.standard_normal((7, 3, 5)) * 0.2).astype(np.float32)
    g = rng.standard_normal(7).astype(np.float32)
    k, d = _port_vjp(inc, g, 1, chunk=3)
    k_scan, d_scan = _jax_vjp(lambda z: j_scan(z, 1), inc, g)
    _, d_prod = _jax_vjp(lambda z: j_solve(z, 1, 3), inc, g)
    np.testing.assert_allclose(k, k_scan, rtol=1e-6)
    for want in (d_scan, d_prod):
        np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-5)
    k1, d1 = _port_vjp(inc, g, 1)          # one chunk: the same numbers
    np.testing.assert_array_equal(k, k1)
    np.testing.assert_array_equal(d, d1)
    want = np.array([_naive_pde(inc[b], 1) for b in range(7)])
    np.testing.assert_allclose(k, want, rtol=1e-5, atol=1e-6)


def test_wavefront_mid_size_grid(rng):
    """L = 12 at λ=2: 87 diagonals, two checkpoint segments."""
    inc = (rng.standard_normal((4, 11, 11)) * 0.1).astype(np.float32)
    g = rng.standard_normal(4).astype(np.float32)
    k, d = _port_vjp(inc, g, 2)
    k_scan, d_scan = _jax_vjp(lambda z: j_scan(z, 2), inc, g)
    np.testing.assert_allclose(k, k_scan, rtol=1e-5)
    scale = np.abs(d_scan).max()
    np.testing.assert_allclose(d / scale, d_scan / scale, atol=5e-4)
    assert -(-(44 + 44 - 1) // sk._SEG) == 2


def test_wavefront_edge_cases(rng):
    np.testing.assert_allclose(solve_goursat_pde(torch.zeros(1, 6, 6), 3).numpy(), 1.0,
                               atol=1e-6)
    assert torch.equal(solve_goursat_pde(torch.zeros(3, 0, 4), 1), torch.ones(3))


CASES = {
    # DuSt's default signature kernel order, a fixed bandwidth
    "lambda2": dict(order=2, bandwidth=2.0, C=2, L=6, scale=0.5),
    # the median bandwidth, three channels
    "lambda1_median": dict(order=1, bandwidth=None, C=3, L=6, scale=0.5),
    # linear statics at λ=0 (K7 takes RBF statics only)
    "lambda0_linear": dict(order=0, static="linear", C=2, L=8, scale=0.3),
    # nine channels at λ=0, beyond K7's C ≤ 8
    "lambda0_c9": dict(order=0, bandwidth=1.5, C=9, L=5, scale=0.5),
    # an explicit wavefront at λ=3 (else the λ=3 kernels)
    "lambda3_wavefront": dict(order=3, bandwidth=4.0, C=2, L=5, scale=0.5,
                              solver="wavefront"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_signature_kernel_wavefront_routes_match_jax(rng, name):
    c = CASES[name]
    X = (rng.standard_normal((5, c["L"], c["C"])) * c["scale"]).astype(np.float32)
    kw = dict(dyadic_order=c["order"], bandwidth=c.get("bandwidth"),
              static=c.get("static", "rbf"), solver=c.get("solver", "auto"))
    tk, jk = SignatureKernel(**kw), JSignatureKernel(**kw)
    L1 = c["L"] - 1
    assert tk._chunk_plan(L1, L1, 15, c["C"], torch.device("cpu"), 1.5)[0] == "wavefront"
    Xt, Xj = torch.from_numpy(X), jnp.asarray(X)

    K, dX = tk.gram_and_grad(Xt)
    Kj, dXj = jk.gram_and_grad(Xj)
    np.testing.assert_allclose(K.numpy(), _n(Kj), rtol=1e-5, atol=3e-5)
    scale = np.abs(_n(dXj)).max()
    np.testing.assert_allclose(dX.numpy() / scale, _n(dXj) / scale, atol=5e-5)

    # JAX's gram_and_grad K is its gram_sym's upper-triangle pair list
    np.testing.assert_allclose(tk.gram_sym(Xt).numpy(), _n(Kj), rtol=1e-5, atol=3e-5)
    # the dense gram with its gradient, against the second argument fixed
    x = Xt.clone().requires_grad_(True)
    G = tk.gram(x, Xt[:3])
    (dG,) = torch.autograd.grad(G.sum(), x)
    Gj, vjp = jax.vjp(lambda a: jk.gram(a, Xj[:3]), Xj)
    (dGj,) = vjp(jnp.ones_like(Gj))
    np.testing.assert_allclose(G.detach().numpy(), _n(Gj), rtol=1e-5, atol=3e-5)
    scale = np.abs(_n(dGj)).max()
    np.testing.assert_allclose(dG.numpy() / scale, _n(dGj) / scale, atol=5e-5)


def test_gram_and_grad_finite_difference(rng):
    """``tests/test_sigkernel.py``'s central-difference check at λ=2."""
    paths = torch.from_numpy((rng.standard_normal((3, 5, 2)) * 0.5).astype(np.float32))
    kern = SignatureKernel(dyadic_order=2, bandwidth=2.0)
    _, dk = kern.gram_and_grad(paths)
    eps = 1e-2

    def total(p):
        return float(kern.gram(p, paths).sum())

    plus, minus = paths.clone(), paths.clone()
    plus[1, 2, 0] += eps
    minus[1, 2, 0] -= eps
    fd = (total(plus) - total(minus)) / (2 * eps)
    np.testing.assert_allclose(float(dk[1, 2, 0]), fd, rtol=5e-2, atol=1e-3)


def test_chunked_pair_lists_match_one_chunk(rng, monkeypatch):
    """Chunks of 4 of a 15-pair triangle (equal chunks, the last of 3) give
    the one-chunk K and gradient; the streamed ``gram`` under a patched
    ``_DENSE_LIMIT`` agrees with the dense one (JAX's test: rtol 1e-5 /
    atol 1e-6, gradient rtol 1e-4 / atol 1e-5)."""
    X = torch.from_numpy((rng.standard_normal((5, 6, 2)) * 0.5).astype(np.float32))
    kern = SignatureKernel(dyadic_order=1, bandwidth=1.5)
    K1, d1 = kern.gram_and_grad(X)
    G1 = kern.gram(X, X)
    monkeypatch.setattr(sk, "wavefront_pair_bytes", lambda *a: 2 * 10**9 // 4)
    assert kern._chunk_plan(5, 5, 15, 2, torch.device("cpu"), 1.5) == ("wavefront", 4, 4)
    K4, d4 = kern.gram_and_grad(X)
    np.testing.assert_allclose(K4.numpy(), K1.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d4.numpy(), d1.numpy(), rtol=1e-6, atol=1e-7)
    streamed = dataclasses.replace(kern)
    object.__setattr__(streamed, "_DENSE_LIMIT", 1)
    x = X.clone().requires_grad_(True)
    Gs = streamed.gram(x, X)
    (ds,) = torch.autograd.grad(Gs.sum(), x)
    x = X.clone().requires_grad_(True)
    (dd,) = torch.autograd.grad(kern.gram(x, X).sum(), x)
    np.testing.assert_allclose(Gs.detach().numpy(), G1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), dd.numpy(), rtol=1e-4, atol=1e-5)


def test_auto_chunk_sizes_by_the_budget():
    per = sk.wavefront_pair_bytes(39, 39, 2)
    assert sk.auto_chunk(39, 39, 2) == 2 * 10**9 // per
    assert sk.auto_chunk(39, 39, 2, budget_bytes=10**6) == 256
    assert sk.wavefront_pair_bytes(39, 39, 2, n_channels=2) > per
