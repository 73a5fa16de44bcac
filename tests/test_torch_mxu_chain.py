"""The port's block-propagator solvers and K8's twin against the JAX package.

* ``_propagator_polys`` and ``_stacked_polys`` are bit-equal to JAX's;
* the fp32 block propagator matches ``solve_goursat_pde_mxu(precision=
  "highest")`` in values and VJP (scaled atol 1e-5 for K, 1e-4 for grads:
  fp32 against fp32, only the sums' order differs);
* K8's twin matches ``solve_goursat_pde_mxu_pallas`` (the Pallas kernel in
  interpret mode) at [3, 2, 2] λ=6 (scaled atol 1e-3 for K, 2e-3 for grads;
  both round to bf16 in the same places, but a last-bit difference in a hop
  input can round to a different bf16), and the fp32 propagator at the
  bf16 tolerance of ``tests/test_pallas_mxu_chain.py`` (5e-3, 1e-2).

K8 itself is held against the twin on the card in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import pallas_mxu_chain as jchain
from sigsvgd_tpu.kernels.sigkernel import _propagator_polys as j_polys
from sigsvgd_tpu.kernels.sigkernel import solve_goursat_pde_mxu as j_mxu
from sigsvgd_tpu_torch.kernels import mxu_chain as mc
from sigsvgd_tpu_torch.kernels.sigkernel import (
    SignatureKernel, _mxu_eligible, _propagator_polys, solve_goursat_pde_mxu,
)


def _inc(rng, b, lx1, ly1):
    return np.clip(rng.standard_normal((b, lx1, ly1)), -2, 2).astype(np.float32)


def _torch_vjp(fn, inc, g):
    t = torch.from_numpy(inc).requires_grad_(True)
    k = fn(t)
    (d,) = torch.autograd.grad(k, t, torch.from_numpy(g))
    return k.detach().numpy(), d.numpy()


def _jax_vjp(fn, inc, g):
    k, vjp = jax.vjp(fn, jnp.asarray(inc))
    (d,) = vjp(jnp.asarray(g))
    return np.asarray(k), np.asarray(d)


def _scaled_close(got, want, atol):
    s = np.abs(want).max()
    np.testing.assert_allclose(got / s, want / s, atol=atol)


@pytest.mark.parametrize("m,degree", [(64, 10), (16, 10), (64, 6)])
def test_bases_are_bit_equal_to_jax(m, degree):
    np.testing.assert_array_equal(_propagator_polys(m, degree), j_polys(m, degree))
    if m == 64:
        for got, want in zip(mc._stacked_polys(degree), jchain._stacked_polys(degree)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,lx1,ly1,lam", [(3, 2, 2, 6), (5, 4, 4, 6)])
def test_fp32_propagator_matches_jax_highest(rng, b, lx1, ly1, lam):
    inc = _inc(rng, b, lx1, ly1)
    g = rng.standard_normal(b).astype(np.float32)
    k, d = _torch_vjp(lambda t: solve_goursat_pde_mxu(t, lam), inc, g)
    kj, dj = _jax_vjp(lambda z: j_mxu(z, lam, degree=10, precision="highest"), inc, g)
    _scaled_close(k, kj, 1e-5)
    _scaled_close(d, dj, 1e-4)


def test_twin_matches_jax_pallas_interpret(rng):
    inc = _inc(rng, 3, 2, 2)
    g = rng.standard_normal(3).astype(np.float32)
    k, d = _torch_vjp(lambda t: mc.solve_goursat_pde_mxu_chain_plain(t, 6), inc, g)
    kj, dj = _jax_vjp(lambda z: jchain.solve_goursat_pde_mxu_pallas(z, 6, degree=10),
                      inc, g)
    _scaled_close(k, kj, 1e-3)
    _scaled_close(d, dj, 2e-3)


@pytest.mark.parametrize("b,lx1,ly1,lam", [(3, 2, 2, 6), (5, 4, 4, 6), (2, 2, 2, 7)])
def test_twin_matches_fp32_propagator(rng, b, lx1, ly1, lam):
    """The JAX suite's bf16 tolerance at its three shapes: 4 hops, 16 hops,
    and 16 hops at λ=7 (two blocks per coarse cell side)."""
    inc = _inc(rng, b, lx1, ly1)
    g = rng.standard_normal(b).astype(np.float32)
    k, d = _torch_vjp(lambda t: mc.solve_goursat_pde_mxu_chain(t, lam), inc, g)
    kr, dr = _torch_vjp(lambda t: solve_goursat_pde_mxu(t, lam), inc, g)
    _scaled_close(k, kr, 5e-3)
    _scaled_close(d, dr, 1e-2)
    # the autograd function and the plain function are the same twin on the CPU
    kp, dp = _torch_vjp(lambda t: mc.solve_goursat_pde_mxu_chain_plain(t, lam), inc, g)
    np.testing.assert_array_equal(k, kp)
    np.testing.assert_array_equal(d, dp)


def test_chain_supported_covers_the_jax_envelope():
    for lam in range(0, 10):
        for lx1 in range(1, 17):
            for ly1 in range(1, 17):
                if jchain.chain_supported(lx1, ly1, lam):
                    assert mc.chain_supported(lx1, ly1, lam), (lx1, ly1, lam)
                if mc.chain_supported(lx1, ly1, lam):
                    assert _mxu_eligible(lx1, ly1, lam)
    for shape in [(2, 2, 6), (4, 4, 6), (2, 2, 7)]:
        assert mc.chain_supported(*shape)
    assert not mc.chain_supported(4, 4, 5)
    assert not mc.chain_supported(9, 8, 6)  # 72 hops


def test_cpu_tensors_leave_the_launch_counters(rng):
    before = (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches)
    _torch_vjp(lambda t: mc.solve_goursat_pde_mxu_chain(t, 6), _inc(rng, 4, 2, 2),
               np.ones(4, np.float32))
    K, dX = SignatureKernel(6, 1.5, mxu_precision="default").gram_and_grad(
        torch.from_numpy(rng.normal(size=(5, 3, 7)).astype(np.float32) * 0.3))
    assert K.shape == (5, 5) and dX.shape == (5, 3, 7)
    assert (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches) == before


def test_explicit_chain_request_outside_its_envelope_raises():
    with pytest.raises(ValueError, match="dyadic_order"):
        mc.solve_goursat_pde_mxu_chain(torch.ones(2, 4, 4), 5)
    with pytest.raises(ValueError, match="block hops"):
        mc.solve_goursat_pde_mxu_chain(torch.ones(2, 9, 9), 6)


def test_solver_routing_matches_jax_on_the_tpu():
    """λ=0 with ly1 ≤ 63 → the "small" kind (K1 or K3 on a block, else the
    K7 pair list; JAX's "pallas_small"), λ=3 with ly1 ≤ 48 → the "pallas"
    kind (K2 or the K4/K6 pair list); MXU-eligible shapes → K8 at "default"
    inside its envelope, else the fp32 propagator ("high" runs as
    "highest"); the rest takes the wavefront, as on the TPU."""
    def kind(lam, lx1, prec="default"):
        return SignatureKernel(lam, 1.5, mxu_precision=prec)._solver_kind(lx1, lx1)

    assert kind(0, 39) == "small" and kind(0, 63) == "small"
    assert kind(3, 39) == "pallas" and kind(3, 48) == "pallas"
    assert kind(6, 2) == "mxu_chain" and kind(7, 2) == "mxu_chain"
    assert kind(6, 2, "highest") == "mxu" and kind(6, 2, "high") == "mxu"
    assert kind(4, 4) == "mxu" and kind(6, 10) == "mxu"   # below λ=6; 100 hops
    for lam, lx1 in [(1, 4), (2, 4), (6, 17), (3, 49), (0, 64)]:
        assert kind(lam, lx1) == "wavefront"
    with pytest.raises(ValueError, match="mxu_precision"):
        SignatureKernel(6, 1.5, mxu_precision="bf16")


def test_kernel_bound_counts():
    bf16, fp32 = mc.chain_flops(1 << 20, 2, 2, 6)
    assert bf16 == (1 << 20) * 4 * 2.0 * 11 * 129 * 128
    assert fp32 == (1 << 20) * 4 * 21 * 129 * 2.0
    assert mc.chain_flops(3, 2, 2, 7)[0] == 3 * 16 * 2.0 * 11 * 129 * 128
    assert mc.chain_bytes(1 << 20, 2, 2) == 4.0 * (1 << 20) * 5
    assert mc.chain_bytes(1 << 20, 2, 2, backward=True) == 4.0 * (1 << 20) * 9
