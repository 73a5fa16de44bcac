"""K4's and K6's plain twins (the λ=3 fused pair-list route) against the JAX
package's ``pallas_pair_gram_fused``, whose Pallas kernels run in interpret
mode on the CPU, at one 2048-pair tile, as ``tests/test_pallas_sigkernel.py``
runs them.

* K4 (fp32): at [6, 5, 2] × [5, 5, 2] with a random pair list, values rtol
  2e-5, atol 1e-6 and the gradients with respect to X, Y (scaled by their
  max, atol 1e-3) and h (relative 1e-3), those of
  ``test_fused_statics_matches_unfused``; at the flagship path length
  [5, 40, 2] values rtol 1e-4, atol 1e-6 and the gradient scaled atol 2e-3,
  those of ``test_fused_statics_mpc_shape``. There 128 random pairs fill
  the tile's head and the rest are the JAX contract's padding (index 0,
  cotangent 0), so the twin solves 128 pairs.
* K6 (bf16) at the shape of ``test_bf16_delta_adjoint_matches_fp32``: values
  bit-equal to the fp32 route's, the gradient within rel 1e-2 of JAX's bf16
  gradient (a bf16 quantum is 3.9e-3; the twin rounds once per operation,
  XLA's CPU code may keep some bf16 intermediates wider, so the two are not
  bit-equal), and within JAX's own bounds of the fp32 gradient: rel < 0.25,
  cos > 0.98.
* The routing predicates agree with JAX's on a grid of shapes.

K4 and K6 themselves are held against the twins on the card in
``test_torch_cuda.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import pallas_sigkernel as jps
from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf

P = jps._P  # one JAX pair tile


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scaled_close(got, want, atol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _port_vjp(X, Y, ix, iy, h, g, prec="fp32"):
    """The port's values and gradients with respect to X, Y and h."""
    Xt = torch.from_numpy(X).requires_grad_(True)
    Yt = torch.from_numpy(Y).requires_grad_(True)
    ht = torch.tensor(h, dtype=torch.float32, requires_grad=True)
    k = kf.pair_gram_fused(Xt, Yt, torch.from_numpy(ix), torch.from_numpy(iy), ht, prec)
    grads = torch.autograd.grad(k, (Xt, Yt, ht), torch.from_numpy(g))
    return k.detach().numpy(), [t.numpy() for t in grads]


def _jax_vjp(X, Y, ix, iy, h, g, prec="fp32"):
    v, vjp = jax.vjp(
        lambda x, y, hh: jps.pallas_pair_gram_fused(
            x, y, jnp.asarray(ix, jnp.int32), jnp.asarray(iy, jnp.int32), hh,
            grad_precision=prec),
        jnp.asarray(X), jnp.asarray(Y), jnp.float32(h))
    return np.asarray(v), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.fixture(scope="module")
def small_pairs():
    """[6, 5, 2] × [5, 5, 2], a random 2048-pair list, h = 1.7: both sides."""
    rng = np.random.default_rng(0)
    n, m, L, C = 6, 5, 5, 2
    X = rng.standard_normal((n, L, C)).astype(np.float32)
    Y = rng.standard_normal((m, L, C)).astype(np.float32)
    ix, iy = rng.integers(0, n, P), rng.integers(0, m, P)
    g = rng.standard_normal(P).astype(np.float32)
    return _port_vjp(X, Y, ix, iy, 1.7, g), _jax_vjp(X, Y, ix, iy, 1.7, g)


def test_k4_twin_values_match_jax(small_pairs):
    (k, _), (kj, _) = small_pairs
    np.testing.assert_allclose(k, kj, rtol=2e-5, atol=1e-6)


def test_k4_twin_path_gradients_match_jax(small_pairs):
    (_, (dX, dY, _)), (_, (dXj, dYj, _)) = small_pairs
    _scaled_close(dX, dXj, 1e-3)
    _scaled_close(dY, dYj, 1e-3)


def test_k4_twin_bandwidth_gradient_matches_jax(small_pairs):
    """The gradient with respect to h flows through the rsqrt(h) pre-scale,
    a torch op outside the kernels."""
    (_, (_, _, dh)), (_, (_, _, dhj)) = small_pairs
    assert abs(float(dh) - float(dhj)) <= 1e-3 * abs(float(dhj))


def test_k4_twin_matches_jax_at_the_flagship_path_length():
    rng = np.random.default_rng(1)
    n, L, C, real = 5, 40, 2, 128
    X = (0.3 * rng.standard_normal((n, L, C))).astype(np.float32)
    ix = np.zeros(P, np.int64)
    iy = np.zeros(P, np.int64)
    ix[:real], iy[:real] = rng.integers(0, n, real), rng.integers(0, n, real)
    g = np.zeros(P, np.float32)
    g[:real] = rng.standard_normal(real)
    kj, (dXj, dYj, _) = _jax_vjp(X, X, ix, iy, 2.3, g)
    Xt = torch.from_numpy(X).requires_grad_(True)
    k = kf.pair_gram_fused(Xt, Xt, torch.from_numpy(ix[:real]),
                           torch.from_numpy(iy[:real]), 2.3)
    (dX,) = torch.autograd.grad(k, Xt, torch.from_numpy(g[:real]))
    np.testing.assert_allclose(k.detach().numpy(), kj[:real], rtol=1e-4, atol=1e-6)
    _scaled_close(dX.numpy(), dXj + dYj, 2e-3)  # X serves as both paths


@pytest.fixture(scope="module")
def bf16_pairs():
    """The shape of ``test_bf16_delta_adjoint_matches_fp32``: [6, 5, 2]
    paths 0.4·cumsum of normals, h = 2, a random 2048-pair list."""
    rng = np.random.default_rng(2)
    n, L, C = 6, 5, 2
    X = (0.4 * np.cumsum(rng.standard_normal((n, L, C)), 1)).astype(np.float32)
    ix, iy = rng.integers(0, n, P), rng.integers(0, n, P)
    g = rng.standard_normal(P).astype(np.float32)
    out = {}
    for prec in ("fp32", "bf16"):
        k, (dX, dY, _) = _port_vjp(X, X, ix, iy, 2.0, g, prec)
        kj, (dXj, dYj, _) = _jax_vjp(X, X, ix, iy, 2.0, g, prec)
        out[prec] = (k, dX + dY, kj, dXj + dYj)  # X and Y are the same paths
    return out


def test_k6_twin_values_equal_the_fp32_route(bf16_pairs):
    np.testing.assert_array_equal(bf16_pairs["bf16"][0], bf16_pairs["fp32"][0])
    np.testing.assert_array_equal(bf16_pairs["bf16"][2], bf16_pairs["fp32"][2])


def test_k6_twin_matches_jax_bf16_gradient(bf16_pairs):
    _, d16, _, d16j = bf16_pairs["bf16"]
    assert _rel(d16, d16j) < 1e-2


def test_k6_twin_is_within_jax_bounds_of_the_fp32_gradient(bf16_pairs):
    d16 = bf16_pairs["bf16"][1]
    d32j = bf16_pairs["fp32"][3]
    cos = float((d16 * d32j).sum() / (np.linalg.norm(d16) * np.linalg.norm(d32j)))
    assert _rel(d16, d32j) < 0.25
    assert cos > 0.98
    # and the fp32 twin matches JAX's fp32 gradient at K4's tolerance
    _scaled_close(bf16_pairs["fp32"][1], d32j, 1e-3)


_GRID = list(itertools.product([1, 5, 39, 40, 48, 1000], [1, 39, 40, 41, 48, 49, 100],
                               [1, 2, 4, 5, 8, 9], ["fp32", "bf16"]))


def test_routing_predicates_match_jax():
    """``pallas_supported``, ``fused_supported`` (with the cases of
    ``test_fused_supported_grad_precision_envelope``), ``_bands_per_ck``,
    ``_n_ck_slots`` and ``_coef`` decide which route and gradient a call
    gets: they agree with the JAX package's everywhere on the grid."""
    for lx1, ly1, C, prec in _GRID:
        for lam in (0, 3, 4):
            assert kf.pallas_supported(lx1, ly1, lam) == jps.pallas_supported(lx1, ly1, lam)
        for static, h in (("rbf", 1.0), ("rbf", None), ("linear", 1.0)):
            assert (kf.fused_supported(lx1, ly1, 3, C, static, h, prec)
                    == jps.fused_supported(lx1, ly1, 3, C, static, h, prec))
        bpc = kf._bands_per_ck(lx1)
        assert bpc == jps._bands_per_ck(lx1)
        assert kf._n_ck_slots(lx1, bpc) == jps._n_ck_slots(lx1, bpc)
    assert kf.fused_supported(48, 48, 3, 8, "rbf", 1.0)
    assert not kf.fused_supported(48, 48, 3, 8, "rbf", 1.0, "bf16")
    assert not kf.fused_supported(39, 39, 3, 5, "rbf", 1.0, "bf16")
    assert kf.fused_supported(39, 39, 3, 2, "rbf", 1.0, "bf16")
    assert kf.fused_supported(40, 40, 3, 4, "rbf", 1.0, "bf16")
    z = np.linspace(-0.05, 0.05, 11).astype(np.float32)
    for got, want in zip(kf._coef(torch.from_numpy(z)), jps._coef(jnp.asarray(z))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


@pytest.mark.parametrize("Lx,Ly", [(5, 5), (14, 9), (3, 7)])
def test_twin_residuals_are_rows_of_the_grid(rng, Lx, Ly):
    """The forward's residuals at JAX's spacing: the checkpoint slots hold
    the node rows above bands bpc-1, 2·bpc-1, … and the last band, ``rc``
    the right-edge column; the values-only forward gives the same k."""
    C, Pn = 2, 6
    xt = torch.from_numpy((0.3 * rng.normal(size=(Lx, C, Pn))).astype(np.float32))
    yt = torch.from_numpy((0.3 * rng.normal(size=(Ly, C, Pn))).astype(np.float32))
    k, ck, rc = kf.fused_forward(xt, yt, residuals=True)   # CPU: the twin
    (k0,) = kf.fused_forward(xt, yt, residuals=False)
    torch.testing.assert_close(k0, k, atol=0, rtol=0)
    A, B = kf.pair_statics(xt, yt)[2:]
    _, grid = kf.grid_forward(A, B, keep_grid=True)
    lx1, bpc = Lx - 1, kf._bands_per_ck(Lx - 1)
    assert ck.shape == (kf._n_ck_slots(lx1, bpc), 8 * (Ly - 1) + 1, Pn)
    assert rc.shape == (lx1, 8, Pn)
    for s in range(ck.shape[0]):
        b = min((s + 1) * bpc, lx1) - 1
        torch.testing.assert_close(ck[s], grid[8 * (b + 1)], atol=0, rtol=0)
    torch.testing.assert_close(rc.reshape(-1, Pn), grid[:-1, -1], atol=0, rtol=0)
    torch.testing.assert_close(k, grid[-1, -1], atol=0, rtol=0)


def test_kernel_bound_counts():
    # the flagship upper triangle: 524,800 pairs of 40-node paths, 312² fine
    # cells, 39² coarse cells, 40² static nodes
    P_, cells, coarse, nodes = 524_800, 312 ** 2, 39 ** 2, 40 ** 2
    fwd, _ = kf.fused_flops(P_, 40, 40, 2)
    assert fwd == P_ * (cells * 4 + coarse * 12 + nodes * 8)
    assert 2.0e11 < fwd < 2.3e11
    bwd, _ = kf.fused_flops(P_, 40, 40, 2, "backward")
    assert bwd == P_ * (cells * 14 + coarse * 12 + nodes * 8 + coarse * 28)
    fp32, bf16 = kf.fused_flops(P_, 40, 40, 2, "bf16")
    assert bf16 == P_ * cells * 12 and fp32 == P_ * (coarse * 12 + nodes * 8 + coarse * 44)
    ck = 7 * 313
    assert kf.fused_bytes(P_, 40, 40, 2) == 4.0 * P_ * (160 + 1 + ck + 312)
    assert kf.residual_bytes(P_, 39, 39) == 4 * P_ * (ck + 312)
    # K4's backward reads the tiles, both residuals and the cotangent and
    # writes both gradients; it keeps its rows in registers: no device
    # scratch, a block's shared memory the y points and their gradients
    # (6·2 floats each a thread) and the stage (40 + 1 + 8 + 4)
    assert kf.fused_bytes(P_, 40, 40, 2, "backward") == 4.0 * P_ * (160 + ck + 312 + 1 + 160)
    plan = kf.fused_plan(P_, 39, 39, 2, "backward")
    assert plan.scratch_bytes == 0
    assert plan.smem_bytes == 4 * 128 * (2 * 12 + 40 + 1 + 8 + 4)
    assert plan.traffic_bytes == {"backward": kf.fused_bytes(P_, 40, 40, 2, "backward")}
    # K6 keeps its rows in registers: no device scratch, a block's shared
    # memory the y points and their gradients (2·6·2 floats each a thread)
    # and the stage of the next unit's inputs (80 + 2 + 16 + 8)
    plan = kf.fused_plan(P_, 39, 39, 2, "bf16")
    assert plan.scratch_bytes == 0
    assert plan.smem_bytes == 4 * 128 * (2 * 24 + 80 + 2 + 16 + 8)
    with pytest.raises(ValueError, match="part"):
        kf.fused_flops(1, 5, 5, 2, "sideways")
