"""The port's ``SignatureKernel`` on the λ=3 pair-list routes against the
JAX package's (``solver="pallas"``, its Pallas kernels in interpret mode),
with the kernels' plain twins in the port:

* ``gram_and_grad`` with ``grad_precision="bf16"`` at [8, 8, 2] (the
  gathered pair list with K6): K atol 1e-4, dX within rel 1e-2 of JAX's bf16
  gradient (K6's twin tolerance, ``test_torch_fused.py``);
* the same at [4, 8, 5], outside the bf16 envelope: the fp32 fused adjoint
  (K4) on both sides, K atol 1e-4 and dX scaled atol 4e-4, and the port's
  result equal to its fp32 pair list's (at fp32 ``gram_and_grad`` takes
  K2 there, as JAX takes its block3 route);
* seven channels: [6, 17, 7] is inside JAX's block3 envelope (L·C = 119)
  and K2's, so both packages take their block route: K atol 1e-4, dX
  scaled 4e-4, the tolerances of ``tests/test_torch_dust.py``'s λ=3 mode;
* ``gram(X, Y)`` above a lowered ``_DENSE_LIMIT`` (patched on both classes
  inside the test), on normal draws with the bandwidth from the 256×256
  block's median: K atol 1e-4, the λ=3 K tolerance of
  ``tests/test_pallas_block3.py`` (both sides' fp32 K is ~8e-5 from fp64
  here, and a last-bit difference in a static node, where the port's
  squared-difference statics and XLA's exp round apart from JAX's, moves K
  by 2e-5 to 5e-5), and the gradient with respect to X through K4 and the
  median, scaled atol 1e-3 (K4's twin tolerance);
* 9 channels, beyond the fused kernels: ``gram_and_grad``'s pair list and
  the dense ``gram``, both through K5's twin, agree (K rtol 2e-5, dX scaled
  1e-5); beyond ly1 = 48 with C = 4 (outside K2) and at λ=0 with C = 9 the
  wavefront takes them, its pair list and its dense ``gram`` agreeing the
  same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels.sigkernel import SignatureKernel as JSignatureKernel
from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
from sigsvgd_tpu_torch.kernels import sigkernel_fused as kf
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel


def _paths(rng, n, L, C, step=0.3):
    return np.cumsum(rng.normal(size=(n, L, C)) * step, axis=1).astype(np.float32)


def _scaled_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _both(X, h, prec):
    K, dX = SignatureKernel(dyadic_order=3, bandwidth=h, grad_precision=prec).gram_and_grad(
        torch.from_numpy(X))
    Kj, dXj = JSignatureKernel(dyadic_order=3, bandwidth=h, solver="pallas",
                               grad_precision=prec).gram_and_grad(jnp.asarray(X))
    return K.numpy(), dX.numpy(), np.asarray(Kj), np.asarray(dXj)


def test_bf16_gram_and_grad_matches_jax(rng):
    K, dX, Kj, dXj = _both(_paths(rng, 8, 8, 2), 2.0, "bf16")
    np.testing.assert_allclose(K, Kj, atol=1e-4)
    np.testing.assert_array_equal(K, K.T)
    assert np.linalg.norm(dX - dXj) / np.linalg.norm(dXj) < 1e-2


def test_bf16_oversize_shape_takes_the_fp32_fused_adjoint(rng):
    X = _paths(rng, 4, 8, 5, 0.15)
    K, dX, Kj, dXj = _both(X, 2.0, "bf16")
    np.testing.assert_allclose(K, Kj, atol=1e-4)
    _scaled_close(dX, dXj, 4e-4)
    kern = SignatureKernel(dyadic_order=3, bandwidth=2.0)
    Xt = torch.from_numpy(X)
    K32, dX32 = kern._pair_gram_and_grad(Xt, kern._subsampled_bandwidth(Xt, Xt))
    np.testing.assert_array_equal(K, K32.numpy())
    np.testing.assert_array_equal(dX, dX32.numpy())


def test_seven_channel_gram_and_grad_matches_jax_block3(rng):
    K, dX, Kj, dXj = _both(_paths(rng, 6, 17, 7, 0.15), 3.0, "fp32")
    np.testing.assert_allclose(K, Kj, atol=1e-4)
    _scaled_close(dX, dXj, 4e-4)


def test_streamed_gram_matches_jax(rng, monkeypatch):
    """Paths of different lengths, so the pair list solves Lx ≠ Ly; normal
    draws, as ``test_fused_statics_matches_unfused`` takes them."""
    X = rng.normal(size=(5, 6, 2)).astype(np.float32)
    Y = rng.normal(size=(4, 7, 2)).astype(np.float32)
    for cls in (SignatureKernel, JSignatureKernel):
        monkeypatch.setattr(cls, "_DENSE_LIMIT", 100)
    assert 5 * 4 * 6 * 7 > SignatureKernel._DENSE_LIMIT
    jk = JSignatureKernel(dyadic_order=3, bandwidth=None, solver="pallas")
    Kj, vjp = jax.vjp(lambda x: jk.gram(x, jnp.asarray(Y)), jnp.asarray(X))
    (dXj,) = vjp(jnp.ones_like(Kj))
    Xt = torch.from_numpy(X).requires_grad_(True)
    K = SignatureKernel(dyadic_order=3, bandwidth=None).gram(Xt, torch.from_numpy(Y))
    (dX,) = torch.autograd.grad(K.sum(), Xt)
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(Kj), atol=1e-4)
    _scaled_close(dX.numpy(), np.asarray(dXj), 1e-3)


def test_streamed_and_dense_gram_agree_on_the_cpu(rng, monkeypatch):
    """With a fixed bandwidth the streamed K4 twin and the dense route (the
    plain solve, which the CPU keeps) compute the same Gram."""
    X, Y = torch.from_numpy(_paths(rng, 4, 9, 3)), torch.from_numpy(_paths(rng, 3, 6, 3))
    kern = SignatureKernel(dyadic_order=3, bandwidth=1.5)
    dense = kern.gram(X, Y)
    monkeypatch.setattr(SignatureKernel, "_DENSE_LIMIT", 10)
    streamed = kern.gram(X, Y)
    np.testing.assert_allclose(streamed.numpy(), dense.numpy(), atol=1e-4)


def test_bf16_pinned_solve_reaches_the_pair_list_route(monkeypatch):
    """The pinned flagship controller with a bf16 kernel sends its Gram and
    adjoint through the pair list's bf16 backward (K6's twin on the CPU),
    not through K2."""
    calls = []
    plain = kf.fused_backward_bf16_plain
    monkeypatch.setattr(kf, "fused_backward_bf16_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    prob = build_arm_mpc(device="cpu", n_pol=6, hz_len=8, calibrate=False,
                         grad_precision="bf16")
    assert prob.ctrl.sig_kernel.dyadic_order == 3
    pol = torch.rand((6, 8, 7), generator=torch.Generator().manual_seed(0)) * 4.0 - 2.0
    k_xx, grad_k = prob.ctrl._kernel_terms(pol, prob.q_start)
    assert calls == [(8, 2, 21)]    # one chunk: the 21 pairs a ≤ b of 6 paths
    assert k_xx.shape == (6, 6) and grad_k.shape == (6, 8, 7)


def test_pair_list_routes_not_ported_raise(rng):
    # C > 8 leaves the fused kernels for K5 (its twin here), on the pair
    # list as on the dense route: K and the detached-argument gradient agree
    X = torch.from_numpy(_paths(rng, 3, 5, 9, 0.15))
    kern = SignatureKernel(dyadic_order=3, bandwidth=1.0)
    K, dX = kern.gram_and_grad(X)
    x = X.clone().requires_grad_(True)
    Kd = kern.gram(x, X)
    (dXd,) = torch.autograd.grad(Kd.sum(), x)
    np.testing.assert_allclose(K.numpy(), Kd.detach().numpy(), rtol=2e-5, atol=1e-6)
    _scaled_close(dX.numpy(), dXd.numpy(), 1e-5)
    # ly1 > 48 with C > 3, and λ=0 with C > 8: the wavefront, on the pair
    # list as on the dense route
    for order, shape, step in ((3, (3, 51, 4), 0.03), (0, (3, 5, 9), 0.15)):
        kern = SignatureKernel(dyadic_order=order, bandwidth=1.0)
        X = torch.from_numpy(_paths(rng, *shape, step))
        K, dX = kern.gram_and_grad(X)
        x = X.clone().requires_grad_(True)
        Kd = kern.gram(x, X)
        (dXd,) = torch.autograd.grad(Kd.sum(), x)
        np.testing.assert_allclose(K.numpy(), Kd.detach().numpy(), rtol=2e-5, atol=1e-6)
        _scaled_close(dX.numpy(), dXd.numpy(), 1e-5)
        np.testing.assert_allclose(kern._gram_chunked_pairs(X, X).numpy(), K.numpy(),
                                   rtol=2e-5, atol=1e-6)
    # the λ=0 pair list itself (K7) now solves: its twin on the CPU
    K = SignatureKernel(dyadic_order=0, bandwidth=1.0)._gram_chunked_pairs(
        torch.zeros(3, 5, 2), torch.zeros(3, 5, 2))
    np.testing.assert_array_equal(K.numpy(), np.ones((3, 3), np.float32))
    with pytest.raises(ValueError, match="grad_precision"):
        SignatureKernel(dyadic_order=3, grad_precision="fp16")


def test_pad_pair_list_adds_zero_pairs():
    ix, sc = torch.arange(5), torch.full((5,), 2.0)
    pix, psc = SignatureKernel._pad_pair_list([ix, sc], 3, 2, 5)
    assert pix.shape == (3, 2) and pix.reshape(-1).tolist() == [0, 1, 2, 3, 4, 0]
    assert psc.reshape(-1).tolist() == [2.0] * 5 + [0.0]
