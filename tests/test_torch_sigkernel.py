"""Port signature kernel against the JAX package.

K1's plain twin is held against JAX ``block_gram_and_grad`` (the Pallas
kernel in interpret mode) and against ``SignatureKernel(solver="wavefront")``
at the four shapes of ``tests/test_pallas_block.py`` and at three of the
block envelope's C = 4..8 (the planner's knots [9, 3, 7] at h = 1.5, and
its edges L = 16 at C = 8 and L = 32 at C = 4), with that file's
tolerances: K atol 3e-5, dX scaled by max|dX| atol 5e-5. K1 itself is held
against the twin on the card in ``test_torch_cuda.py``. Wherever the JAX
package takes its block routes (``block_supported``, ``block3_supported``)
the port's ``_block_route`` takes K1 or K2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import pallas_sigkernel_block as jblock
from sigsvgd_tpu.kernels import pallas_sigkernel_block3 as jblock3
from sigsvgd_tpu.kernels.pallas_sigkernel_block import block_gram_and_grad as j_block
from sigsvgd_tpu.kernels.sigkernel import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.kernels.sigkernel import gram_increments as j_gram_increments
from sigsvgd_tpu.kernels.sigkernel import static_gram_rbf as j_static_gram_rbf
from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
from sigsvgd_tpu_torch.kernels.sigkernel import (
    SignatureKernel, gram_increments, static_gram_rbf,
)

SHAPES = [
    (20, 9, 2, 4.0),     # multi-tile row dimension
    (7, 5, 3, 2.0),      # n < one row block
    (130, 6, 2, 3.0),    # n > one column block
    (33, 21, 3, 4.0),    # odd n, long paths
    (9, 3, 7, 1.5),      # the planner's 7-joint knots at its bandwidth
    (3, 16, 8, 8.0),     # C = 8 at the envelope's L·C = 128
    (3, 32, 4, 8.0),     # C = 4 at L·C = 128 (16 lanes a pair)
]


def _assert_k_dx(K, dX, Kw, dXw):
    np.testing.assert_allclose(np.asarray(K), np.asarray(Kw), atol=3e-5)
    scale = float(np.abs(np.asarray(dXw)).max())
    np.testing.assert_allclose(np.asarray(dX) / scale, np.asarray(dXw) / scale, atol=5e-5)


@pytest.mark.parametrize("n,L,C,h", SHAPES)
def test_plain_twin_matches_jax_block_and_wavefront(rng, n, L, C, h):
    X = (rng.normal(size=(n, L, C)) * 0.3).astype(np.float32)
    K, dX = kb.block_gram_and_grad(torch.from_numpy(X), h)  # CPU: the twin
    assert K.shape == (n, n) and dX.shape == (n, L, C)
    Kb, dXb = j_block(jnp.asarray(X), jnp.asarray(h, jnp.float32))
    _assert_k_dx(K.numpy(), dX.numpy(), Kb, dXb)
    Kw, dXw = JSignatureKernel(dyadic_order=0, bandwidth=h,
                               solver="wavefront").gram_and_grad(jnp.asarray(X))
    _assert_k_dx(K.numpy(), dX.numpy(), Kw, dXw)


def test_gram_and_grad_routes_lambda0_to_the_twin_on_cpu(rng):
    """The port's gram_and_grad matches JAX's block route (as
    ``test_signature_kernel_routes_to_block``), K is symmetric with
    K(x, x) ≥ 1, and the median bandwidth matches JAX's."""
    X = (rng.normal(size=(24, 11, 2)) * 0.3).astype(np.float32)
    K, dX = SignatureKernel(dyadic_order=0, bandwidth=3.0).gram_and_grad(
        torch.from_numpy(X))
    Kj, dXj = JSignatureKernel(dyadic_order=0, bandwidth=3.0,
                               solver="pallas_small").gram_and_grad(jnp.asarray(X))
    _assert_k_dx(K.numpy(), dX.numpy(), Kj, dXj)
    np.testing.assert_array_equal(K.numpy(), K.numpy().T)
    assert np.all(np.diag(K.numpy()) >= 1.0 - 3e-5)
    h_t = SignatureKernel(dyadic_order=0)._subsampled_bandwidth(
        torch.from_numpy(X), torch.from_numpy(X))
    h_j = JSignatureKernel(dyadic_order=0)._subsampled_bandwidth(
        jnp.asarray(X), jnp.asarray(X))
    np.testing.assert_allclose(float(h_t), float(h_j), rtol=1e-6)


def test_static_gram_and_increments_match(rng):
    X = (rng.normal(size=(3, 7, 2)) * 0.5).astype(np.float32)
    Y = (rng.normal(size=(4, 6, 2)) * 0.5).astype(np.float32)
    g_t = static_gram_rbf(torch.from_numpy(X), torch.from_numpy(Y), 2.0)
    g_j = j_static_gram_rbf(jnp.asarray(X), jnp.asarray(Y), 2.0)
    assert g_t.shape == (3, 4, 7, 6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6)
    np.testing.assert_allclose(gram_increments(g_t).numpy(),
                               np.asarray(j_gram_increments(g_j)), atol=1e-6)


@pytest.mark.parametrize("order", [0, 1])
def test_plain_gram_matches_jax(rng, order):
    X = (rng.normal(size=(5, 6, 2)) * 0.4).astype(np.float32)
    Y = (rng.normal(size=(4, 6, 2)) * 0.4).astype(np.float32)
    for bw in (2.0, None):
        got = SignatureKernel(dyadic_order=order, bandwidth=bw).gram(
            torch.from_numpy(X), torch.from_numpy(Y))
        want = JSignatureKernel(dyadic_order=order, bandwidth=bw,
                                solver="wavefront").gram(jnp.asarray(X), jnp.asarray(Y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_calibration_bound_and_order_match(rng):
    steps = rng.uniform(-0.1, 0.1, size=(40, 40, 2)).astype(np.float32)
    X = np.cumsum(steps, axis=1)
    for bw in (4.0, None):
        tk = SignatureKernel(dyadic_order=3, bandwidth=bw)
        jk = JSignatureKernel(dyadic_order=3, bandwidth=bw)
        b_t = float(tk.calibration_bound(torch.from_numpy(X)))
        b_j = float(jk.calibration_bound(jnp.asarray(X)))
        np.testing.assert_allclose(b_t, b_j, rtol=1e-3)
        for tol in (b_j * 0.5, b_j * 2.0):
            assert (tk.calibrate_dyadic_order(torch.from_numpy(X), tol).dyadic_order
                    == jk.calibrate_dyadic_order(jnp.asarray(X), tol).dyadic_order)
    assert SignatureKernel(dyadic_order=0).calibrate_dyadic_order(
        torch.from_numpy(X)).dyadic_order == 0


def test_unported_routes_raise(rng):
    # orders 1 and 2, and order 4 beyond the block propagator's 256 hops
    # (20² at 21-node paths), take the JAX package's wavefront route, now
    # ported: at orders 1 and 2 against JAX (K rtol 1e-5 / atol 3e-5, dX
    # scaled 5e-5, tests/test_torch_wavefront.py); order 4 at 5-node paths
    # is a block-propagator shape (test_torch_mxu_chain.py)
    for order, L in ((1, 5), (2, 5), (4, 21)):
        kern = SignatureKernel(dyadic_order=order, bandwidth=1.0)
        assert kern._solver_kind(L - 1, L - 1) == "wavefront"
        if order == 4:
            K, dX = kern.gram_and_grad(torch.zeros(4, L, 2))
            assert torch.equal(K, torch.ones(4, 4)) and not dX.any()
            continue
        X = (rng.standard_normal((4, L, 2)) * 0.5).astype(np.float32)
        K, dX = kern.gram_and_grad(torch.from_numpy(X))
        Kj, dXj = JSignatureKernel(dyadic_order=order, bandwidth=1.0).gram_and_grad(
            jnp.asarray(X))
        np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5, atol=3e-5)
        scale = np.abs(np.asarray(dXj)).max()
        np.testing.assert_allclose(dX.numpy() / scale, np.asarray(dXj) / scale, atol=5e-5)
    # outside K2's envelope and beyond the pair list's ly1 ≤ 48: the
    # wavefront (on the card: test_torch_cuda.py)
    assert not kb3.block3_supported(4, 65, 2, 1.0)
    assert SignatureKernel(3, 1.0)._solver_kind(64, 64) == "wavefront"


def test_block_supported_envelope():
    assert kb.block_supported(1024, 40, 2, 4.0)
    assert kb.block_supported(2, 64, 3, 1.0)
    assert not kb.block_supported(64, 40, 2, None)      # bandwidth
    assert not kb.block_supported(64, 65, 2, 4.0)       # path length
    assert not kb.block_supported(1, 40, 2, 4.0)        # one particle
    assert not kb.block_supported(64, 5, 9, 4.0)        # channels
    # C = 4..8 up to L·C = 128, and not one node further
    for C, L in ((4, 32), (5, 25), (6, 21), (7, 18), (8, 16)):
        assert kb.block_supported(1024, L, C, 4.0) and kb.block_supported(2, 2, C, 4.0)
        assert not kb.block_supported(1024, L + 1, C, 4.0), (L + 1, C)
    assert kb.block_supported(1024, 3, 7, 1.5)          # the planner's knots


@pytest.mark.parametrize("order", [0, 3])
def test_block_route_covers_the_jax_block_envelopes(order):
    """At every C ≤ 8 and 2 ≤ L ≤ 64 where the JAX package's
    ``gram_and_grad`` takes its block kernel (``block_supported`` at λ=0,
    ``block3_supported`` at λ=3), the port's ``_block_route`` takes K1 or
    K2: the planner's [n, 3, 7] knots included."""
    kern = SignatureKernel(dyadic_order=order, bandwidth=1.0)
    want = "k1" if order == 0 else "k2"
    jax_takes = (jblock.block_supported if order == 0 else jblock3.block3_supported)
    covered = set()
    for C in range(1, 9):
        for L in range(2, 65):
            if jax_takes(64, L, C, "rbf", 1.0):
                assert kern._block_route(64, L, C, 1.0) == want, (L, C)
                covered.add(C)
    assert covered == set(range(1, 9)) and kern._block_route(64, 3, 7, 1.5) == want


@pytest.mark.parametrize("order", [0, 3])
def test_gram_and_grad_takes_the_block_twin_on_planner_knots(rng, order, monkeypatch):
    """``SignatureKernel(order).gram_and_grad`` on the planner's [9, 3, 7]
    knots (joint-limit-like draws, h = 1.5) takes the block twin (K1's at
    λ=0, K2's at λ=3) and matches the JAX package's ``gram_and_grad``, which
    takes its block route there: K atol 3e-5 / 1e-4, dX scaled 5e-5 / 4e-4,
    the block kernels' tolerances."""
    mod, name = (kb, "block_gram_and_grad_plain") if order == 0 else (
        kb3, "block3_gram_and_grad_plain")
    calls = []
    plain = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda X, h, **kw: calls.append(X.shape) or plain(X, h, **kw))
    X = rng.uniform(-2.5, 2.5, size=(9, 3, 7)).astype(np.float32)
    K, dX = SignatureKernel(dyadic_order=order, bandwidth=1.5).gram_and_grad(
        torch.from_numpy(X))
    assert calls == [(9, 3, 7)]
    Kj, dXj = JSignatureKernel(dyadic_order=order, bandwidth=1.5).gram_and_grad(jnp.asarray(X))
    k_tol, dx_tol = (3e-5, 5e-5) if order == 0 else (1e-4, 4e-4)
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), atol=k_tol)
    scale = float(np.abs(np.asarray(dXj)).max())
    np.testing.assert_allclose(dX.numpy() / scale, np.asarray(dXj) / scale, atol=dx_tol)


def test_kernel_bound_counts():
    # 524,800 pairs at the flagship shape; 40² static nodes, 39² cells
    assert kb.block_flops(1024, 40, 2) == 524_800 * (40 * 40 * 7 + 39 ** 2 * 58)
    assert kb.block_bytes(1024, 40, 2) == 4.0 * (1024 * 80 * 2 + 1024 ** 2)
