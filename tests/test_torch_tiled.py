"""K5's plain twins (the λ=3 solve on given increments) against the JAX
package: ``solve_goursat_pde_pallas`` (its Pallas kernels in interpret mode
on the CPU) and ``solve_goursat_pde_scan``, at the shapes and tolerances of
``tests/test_pallas_sigkernel.py``:

* the forward against both at (5, 3, 3), (4, 3, 5), (3, 5, 5): rtol 2e-5,
  atol 1e-6;
* the VJP against the scan's AD at (4, 3, 3), (3, 4, 4), (2, 2, 5) and at
  2,561 pairs of (3, 3): k rtol 2e-5, dz scaled by max|dz| atol 5e-4;
* the MPC shape [3, 40, 40] at scale 0.05: k rtol 1e-4, dz scaled 1e-3;
* the checkpoints against the JAX forward's (``_fwd_call``) at lx1 = 7 (two
  slots) and lx1 = 4 < 6, and the slot count against ``_n_ck_slots`` and
  ``_bands_per_ck`` up to lx1 = 39 (7 slots);
* ``pair_values`` against ``pallas_pair_values`` for RBF and linear statics
  at n=7, L=5, C=2 (2048 random pairs, one tile), values and the pull-back
  gradients with respect to X and Y: rtol 2e-4 and scaled 2e-3
  (``test_pallas_pair_values_matches_generic_statics``).

K5 itself is held against the twins on the card in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import pallas_sigkernel as jps
from sigsvgd_tpu.kernels.sigkernel import solve_goursat_pde_scan
from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt


def _scaled_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _port_vjp(inc, g):
    x = torch.from_numpy(inc).requires_grad_(True)
    k = kt.solve_goursat_pde_tiled(x, 3)
    (d,) = torch.autograd.grad(k, x, torch.from_numpy(g))
    return k.detach().numpy(), d.numpy()


def _scan_vjp(inc, g):
    k, vjp = jax.vjp(lambda z: solve_goursat_pde_scan(z, 3), jnp.asarray(inc))
    return np.asarray(k), np.asarray(vjp(jnp.asarray(g))[0])


def test_forward_matches_jax_pallas_and_scan(rng):
    for b, lx, ly in ((5, 3, 3), (4, 3, 5), (3, 5, 5)):
        inc = (rng.standard_normal((b, lx, ly)) * 0.3).astype(np.float32)
        got = kt.solve_goursat_pde_tiled(torch.from_numpy(inc)).numpy()
        for want in (solve_goursat_pde_scan(jnp.asarray(inc), 3),
                     jps.solve_goursat_pde_pallas(jnp.asarray(inc), 3)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("b,lx,ly", [(4, 3, 3), (3, 4, 4), (2, 2, 5), (2561, 3, 3)])
def test_vjp_matches_scan_ad(rng, b, lx, ly):
    inc = (rng.standard_normal((b, lx, ly)) * 0.3).astype(np.float32)
    g = rng.standard_normal(b).astype(np.float32)
    k, d = _port_vjp(inc, g)
    k_ref, d_ref = _scan_vjp(inc, g)
    np.testing.assert_allclose(k, k_ref, rtol=2e-5)
    _scaled_close(d, d_ref, 5e-4)


def test_mpc_shape_matches_scan(rng):
    inc = (rng.standard_normal((3, 40, 40)) * 0.05).astype(np.float32)
    g = rng.standard_normal(3).astype(np.float32)
    k, d = _port_vjp(inc, g)
    k_ref, d_ref = _scan_vjp(inc, g)
    np.testing.assert_allclose(k, k_ref, rtol=1e-4)
    _scaled_close(d, d_ref, 1e-3)


@pytest.mark.parametrize("lx1,ly1", [(7, 3), (4, 2)])
def test_checkpoints_match_the_jax_forward(rng, lx1, ly1):
    """The slots hold the fine rows the JAX forward stores (the tops of
    every ``bpc``-th band and of the last), in its tile layout
    ``[nt, nslots, G1, 16, 128]`` with pair p at ``(p // 128, p % 128)``."""
    b = 20
    inc = (rng.standard_normal((b, lx1, ly1)) * 0.3).astype(np.float32)
    z, _, nt = jps._pad_pairs(jnp.asarray(inc) / 64.0)
    kj, ckj = jps._fwd_call(z, nt, lx1, ly1, with_ck=True)
    zt = torch.from_numpy(inc / 64.0).permute(1, 2, 0).contiguous()
    k, ck = kt.tiled_forward(zt, with_ck=True)
    ckj = np.asarray(ckj).reshape(nt, ck.shape[0], ck.shape[1], -1)[0, :, :, :b]
    assert ck.shape == (jps._n_ck_slots(lx1, jps._bands_per_ck(lx1)), 8 * ly1 + 1, b)
    np.testing.assert_allclose(ck.numpy(), ckj, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(k.numpy(), np.asarray(kj).reshape(-1)[:b], rtol=2e-5,
                               atol=1e-6)
    (k_values,) = kt.tiled_forward(zt, with_ck=False)
    np.testing.assert_array_equal(k_values.numpy(), k.numpy())


def test_checkpoint_slots_match_the_jax_spacing():
    for lx1 in (1, 2, 5, 6, 7, 12, 13, 39):
        bpc = jps._bands_per_ck(lx1)
        assert kt._bands_per_ck(lx1) == bpc
        assert kt._n_ck_slots(lx1, bpc) == jps._n_ck_slots(lx1, bpc)
        assert len(kt._tops(lx1, bpc)) == jps._n_ck_slots(lx1, bpc)
    assert jps._n_ck_slots(39, jps._bands_per_ck(39)) == 7
    assert kt.residual_bytes(1, 39, 39) == 4 * 7 * 313


@pytest.mark.parametrize("static", ["rbf", "linear"])
def test_pair_values_match_jax(rng, static):
    n, L, C, P = 7, 5, 2, jps._P
    X = rng.standard_normal((n, L, C)).astype(np.float32)
    Y = rng.standard_normal((n, L, C)).astype(np.float32)
    ix, iy = rng.integers(0, n, P), rng.integers(0, n, P)
    g = rng.standard_normal(P).astype(np.float32)
    h = None if static == "linear" else 2.0
    v, vjp = jax.vjp(lambda x, y: jps.pallas_pair_values(
        x, y, jnp.asarray(ix), jnp.asarray(iy), None if h is None else jnp.float32(h)),
        jnp.asarray(X), jnp.asarray(Y))
    grads_j = vjp(jnp.asarray(g))
    Xt, Yt = (torch.from_numpy(a).requires_grad_(True) for a in (X, Y))
    k = kt.pair_values(Xt, Yt, torch.from_numpy(ix), torch.from_numpy(iy), h)
    grads = torch.autograd.grad(k, (Xt, Yt), torch.from_numpy(g))
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(v), rtol=2e-4)
    for got, want in zip(grads, grads_j):
        _scaled_close(got.numpy(), np.asarray(want), 2e-3)


def test_bounds_count_the_function():
    # 524,800 pairs of the flagship triangle list: 39² coarse cells
    P, cells = 524_800, 39 * 39
    assert kt.tiled_flops(P, 39, 39) == P * cells * (6 + 4 * 64)
    assert kt.tiled_flops(P, 39, 39, "backward") == P * cells * (12 + 14 * 64)
    assert kt.tiled_bytes(P, 39, 39, "values") == 4.0 * P * (cells + 1)
    assert kt.tiled_bytes(P, 39, 39) == 4.0 * P * (cells + 1 + 7 * 313)
    assert kt.tiled_bytes(P, 39, 39, "backward") == 4.0 * P * (2 * cells + 1 + 7 * 313)
    assert kt.kernel_supported(1000, 48) and not kt.kernel_supported(5, 49)


def test_chunk_sizing_counts_statics_grids_only_for_rbf():
    """Linear statics keep no statics grids for the backward, so the
    flagship linear triangle list fits a quarter of an 80 GB card in one
    chunk; RBF statics add the exp's output and the clamp's mask."""
    linear = kt.chunk_pair_bytes(39, 39, 2, "cuda", rbf=False)
    assert linear == 4 * (7 * 313 + 3 * 39 * 39) + 16 * 80 * 2
    assert kt.chunk_pair_bytes(39, 39, 2, "cuda", rbf=True) == linear + 4 * 2 * 40 * 40
    assert 524_800 * linear <= 80 * 10**9 // 4


def test_cpu_tensors_leave_the_launch_counters(rng):
    before = (kt.tiled_forward.launches, kt.tiled_backward.launches)
    _port_vjp((rng.standard_normal((3, 4, 4)) * 0.3).astype(np.float32),
              np.ones(3, np.float32))
    assert (kt.tiled_forward.launches, kt.tiled_backward.launches) == before
