"""Port λ=3 signature kernel (K2's plain twin) against the JAX package.

The twin is held against JAX ``block3_gram_and_grad`` (the Pallas kernels in
interpret mode, as ``tests/test_pallas_block3.py`` runs them) and against
``SignatureKernel(dyadic_order=3, solver="wavefront")`` at that file's three
shapes and at three of the block3 envelope's C = 4..8 (the planner's knots
[9, 3, 7] at h = 1.5, and its edges L = 16 at C = 8 and L = 32 at C = 4),
with that file's tolerances: K atol 1e-4, dX scaled by max|dX| atol 4e-4.
K2 itself is held against the twin on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels.pallas_sigkernel_block3 import block3_gram_and_grad as j_block3
from sigsvgd_tpu.kernels.sigkernel import SignatureKernel as JSignatureKernel
from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

SHAPES = [
    (20, 9, 2, 4.0),     # multi-tile row dimension
    (7, 5, 3, 2.0),      # n < one row block
    (12, 13, 2, 3.0),    # longer paths
    (9, 3, 7, 1.5),      # the planner's 7-joint knots at its bandwidth
    (3, 16, 8, 8.0),     # C = 8 at the envelope's L·C = 128
    (3, 32, 4, 8.0),     # C = 4 at L·C = 128 (16 lanes a pair)
]


def _assert_k_dx(K, dX, Kw, dXw):
    np.testing.assert_allclose(np.asarray(K), np.asarray(Kw), atol=1e-4)
    scale = float(np.abs(np.asarray(dXw)).max())
    np.testing.assert_allclose(np.asarray(dX) / scale, np.asarray(dXw) / scale, atol=4e-4)


@pytest.mark.parametrize("n,L,C,h", SHAPES)
def test_plain_twin_matches_jax_block3_and_wavefront(rng, n, L, C, h):
    X = (rng.normal(size=(n, L, C)) * 0.3).astype(np.float32)
    K, dX = kb3.block3_gram_and_grad(torch.from_numpy(X), h)  # CPU: the twin
    assert K.shape == (n, n) and dX.shape == (n, L, C)
    Kb, dXb = j_block3(jnp.asarray(X), jnp.asarray(h, jnp.float32))
    _assert_k_dx(K.numpy(), dX.numpy(), Kb, dXb)
    Kw, dXw = JSignatureKernel(dyadic_order=3, bandwidth=h,
                               solver="wavefront").gram_and_grad(jnp.asarray(X))
    _assert_k_dx(K.numpy(), dX.numpy(), Kw, dXw)


def test_gram_and_grad_routes_lambda3_to_the_twin_on_cpu(rng):
    """The port's gram_and_grad at order 3 matches JAX's block3 route (as
    ``test_signature_kernel_routes_to_block3``); K is symmetric."""
    X = (rng.normal(size=(24, 11, 2)) * 0.3).astype(np.float32)
    K, dX = SignatureKernel(dyadic_order=3, bandwidth=3.0).gram_and_grad(
        torch.from_numpy(X))
    Kj, dXj = JSignatureKernel(dyadic_order=3, bandwidth=3.0,
                               solver="pallas").gram_and_grad(jnp.asarray(X))
    _assert_k_dx(K.numpy(), dX.numpy(), Kj, dXj)
    np.testing.assert_array_equal(K.numpy(), K.numpy().T)


@pytest.mark.parametrize("n,L,C,h", SHAPES)
def test_values_only_twin_matches_the_full_twin(rng, n, L, C, h):
    X = torch.from_numpy((rng.normal(size=(n, L, C)) * 0.3).astype(np.float32))
    K, _ = kb3.block3_gram_and_grad_plain(X, h)
    np.testing.assert_array_equal(kb3.block3_gram_plain(X, h).numpy(), K.numpy())


@pytest.mark.parametrize("n,L,C,h", SHAPES)
def test_chunked_twin_matches_the_whole_twin(rng, n, L, C, h):
    """Solving the pairs a few at a time (as the card check at the flagship
    shape does, to bound the twin's memory) changes only the order of dX's
    sums."""
    X = torch.from_numpy((rng.normal(size=(n, L, C)) * 0.3).astype(np.float32))
    K, dX = kb3.block3_gram_and_grad_plain(X, h)
    Kc, dXc = kb3.block3_gram_and_grad_plain(X, h, pairs_per_chunk=7)
    np.testing.assert_allclose(Kc.numpy(), K.numpy(), rtol=1e-6, atol=1e-7)
    scale = float(dX.abs().max())
    np.testing.assert_allclose(dXc.numpy() / scale, dX.numpy() / scale, atol=1e-6)


def test_block3_supported_envelope():
    assert kb3.block3_supported(1024, 40, 2, 4.0)       # the flagship τ paths
    assert kb3.block3_supported(2, 49, 3, 1.0)          # L ≤ 49 with C ≤ 3, n = 2
    assert kb3.block3_supported(4096, 64, 3, 1.0)       # any n; L up to 64
    assert not kb3.block3_supported(64, 40, 2, None)    # bandwidth
    assert not kb3.block3_supported(64, 5, 9, 4.0)      # channels
    assert not kb3.block3_supported(64, 65, 2, 4.0)     # path length
    assert not kb3.block3_supported(1, 40, 2, 4.0)      # one particle
    # C = 4..8 up to L·C = 128 (ly1 ≤ 31), and not one node further
    for C, L in ((4, 32), (5, 25), (6, 21), (7, 18), (8, 16)):
        assert kb3.block3_supported(1024, L, C, 4.0) and kb3.block3_supported(2, 2, C, 4.0)
        assert not kb3.block3_supported(1024, L + 1, C, 4.0), (L + 1, C)
    assert kb3.block3_supported(1024, 3, 7, 1.5)        # the planner's knots


def test_kernel_bound_counts():
    # 524,800 pairs at the flagship shape: 312² fine cells at 14, 39² coarse
    # cells at 48, 40² static nodes at 7; ~7.6e11 operations
    per_pair = 312 ** 2 * 14 + 39 ** 2 * 48 + 40 ** 2 * 7
    assert kb3.block3_flops(1024, 40, 2) == 524_800 * per_pair
    assert 7.5e11 < kb3.block3_flops(1024, 40, 2) < 7.7e11
    assert kb3.block3_bytes(1024, 40, 2) == 4.0 * (1024 * 80 * 2 + 1024 ** 2)
    # per persistent block: 4 warps × 319 pipeline steps × (32 lanes' band
    # tops of 5 coarse columns + 4 groups' right-edge columns)
    assert kb3.block3_scratch_floats(40, 2) == 4 * 319 * (32 * 40 + 4 * 8)
