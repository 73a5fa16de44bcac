"""The port's ``SignatureKernel`` on the routes K5 serves against the JAX
package's (``solver="pallas"``: its Pallas kernels in interpret mode), with
K5's plain twin in the port:

* the dense λ=3 ``gram(X, Y)`` with its gradient with respect to X, for RBF
  statics (the median bandwidth, scaled by ``bw_scale``) and linear statics:
  K rtol 2e-4, dX scaled 2e-3, the pair-values tolerances of
  ``test_pallas_pair_values_matches_generic_statics``;
* linear statics on the pair list: ``gram_and_grad`` (K rtol 2e-4, dX
  scaled 2e-3), ``gram_sym`` with its gradient, and the streamed ``gram``
  under a lowered ``_DENSE_LIMIT`` (patched on both classes), against
  JAX's;
* 12 channels (beyond the fused kernels' C ≤ 8), RBF statics:
  ``gram_and_grad`` and the streamed ``gram``;
* ``calibration_bound`` of linear statics (rtol 1e-3, as
  ``test_calibration_bound_and_order_match``);
* the linear ``gram`` at dyadic order 3 against the inner product of
  depth-6 truncated signatures from JAX's ``batch_signature``, rtol 2e-3 /
  atol 2e-3 (``test_matches_truncated_signature_inner_product``);
* the ``solver`` field mapped to the port's routes, "wavefront" (and every
  shape the JAX package sends to its XLA wavefront) to the wavefront;
  ``build_arm_mpc(static="linear")`` with a calibration building (order 0
  takes the wavefront), and without one reaching K5's twin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels.sigkernel import SignatureKernel as JSignatureKernel
from sigsvgd_tpu.kernels.signature import batch_signature
from sigsvgd_tpu_torch.experiments.arm_mpc import build_arm_mpc
from sigsvgd_tpu_torch.kernels import sigkernel_tiled as kt
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel

K_RTOL, DX_SCALED = 2e-4, 2e-3


def _paths(rng, n, L, C, step=0.3):
    return np.cumsum(rng.normal(size=(n, L, C)) * step, axis=1).astype(np.float32)


def _scaled_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _gram_vjp(kern, jkern, X, Y):
    """``gram(X, Y)`` and the gradient of its sum with respect to X, port
    and JAX."""
    Kj, vjp = jax.vjp(lambda x: jkern.gram(x, jnp.asarray(Y)), jnp.asarray(X))
    (dXj,) = vjp(jnp.ones_like(Kj))
    Xt = torch.from_numpy(X).requires_grad_(True)
    K = kern.gram(Xt, torch.from_numpy(Y))
    (dX,) = torch.autograd.grad(K.sum(), Xt)
    return K.detach().numpy(), dX.numpy(), np.asarray(Kj), np.asarray(dXj)


def _assert_k_dx(K, dX, Kj, dXj):
    np.testing.assert_allclose(K, Kj, rtol=K_RTOL)
    _scaled_close(dX, dXj, DX_SCALED)


@pytest.mark.parametrize("static,bw_scale", [("rbf", 0.7), ("linear", 1.0)])
def test_dense_gram_matches_jax(rng, static, bw_scale):
    X, Y = _paths(rng, 4, 6, 2), _paths(rng, 3, 5, 2)
    kw = dict(dyadic_order=3, bandwidth=None, static=static, bw_scale=bw_scale)
    kern = SignatureKernel(**kw)
    before = kt.tiled_forward.launches
    _assert_k_dx(*_gram_vjp(kern, JSignatureKernel(solver="pallas", **kw), X, Y))
    assert kt.tiled_forward.launches == before      # the CPU runs the twin
    np.testing.assert_array_equal(kern(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
                                  kern.gram(torch.from_numpy(X), torch.from_numpy(Y)).numpy())


def test_linear_pair_list_routes_match_jax(rng, monkeypatch):
    """``gram_and_grad`` and ``gram_sym`` on the upper-triangle pair list
    and the streamed ``gram``, all through K5's twin."""
    X, Y = _paths(rng, 5, 6, 2), _paths(rng, 4, 7, 2)
    kern = SignatureKernel(dyadic_order=3, static="linear")
    jkern = JSignatureKernel(dyadic_order=3, static="linear", solver="pallas")
    K, dX = kern.gram_and_grad(torch.from_numpy(X))
    Kj, dXj = jkern.gram_and_grad(jnp.asarray(X))
    _assert_k_dx(K.numpy(), dX.numpy(), np.asarray(Kj), np.asarray(dXj))
    Xt = torch.from_numpy(X).requires_grad_(True)
    S = kern.gram_sym(Xt)
    (dS,) = torch.autograd.grad(S.sum(), Xt)
    np.testing.assert_allclose(S.detach().numpy(), np.asarray(Kj), rtol=K_RTOL)
    _scaled_close(0.5 * dS.numpy(), np.asarray(dXj), DX_SCALED)
    for cls in (SignatureKernel, JSignatureKernel):
        monkeypatch.setattr(cls, "_DENSE_LIMIT", 100)
    _assert_k_dx(*_gram_vjp(kern, jkern, X, Y))


def test_twelve_channel_routes_match_jax(rng, monkeypatch):
    """C = 12 is outside the fused kernels (C ≤ 8) and K2 (C ≤ 3): the
    pair list on increments built in torch, K5's twin."""
    X, Y = _paths(rng, 4, 6, 12, 0.15), _paths(rng, 3, 6, 12, 0.15)
    kern = SignatureKernel(dyadic_order=3, bandwidth=2.5)
    jkern = JSignatureKernel(dyadic_order=3, bandwidth=2.5, solver="pallas")
    K, dX = kern.gram_and_grad(torch.from_numpy(X))
    Kj, dXj = jkern.gram_and_grad(jnp.asarray(X))
    _assert_k_dx(K.numpy(), dX.numpy(), np.asarray(Kj), np.asarray(dXj))
    for cls in (SignatureKernel, JSignatureKernel):
        monkeypatch.setattr(cls, "_DENSE_LIMIT", 100)
    _assert_k_dx(*_gram_vjp(kern, jkern, X, Y))


def test_linear_calibration_bound_matches_jax(rng):
    X = _paths(rng, 40, 40, 2, 0.1)
    got = SignatureKernel(dyadic_order=3, static="linear").calibration_bound(
        torch.from_numpy(X))
    want = JSignatureKernel(dyadic_order=3, static="linear").calibration_bound(
        jnp.asarray(X))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)


def test_linear_gram_is_the_truncated_signature_inner_product(rng):
    x = rng.standard_normal((4, 6, 2)).astype(np.float32) * 0.3
    K = SignatureKernel(dyadic_order=3, static="linear").gram(
        torch.from_numpy(x), torch.from_numpy(x)).numpy()
    sigs = np.asarray(batch_signature(jnp.asarray(x), depth=6, basepoint=False))
    np.testing.assert_allclose(K, 1.0 + sigs @ sigs.T, rtol=2e-3, atol=2e-3)


def test_solver_field_maps_to_the_port_routes():
    def kind(lam, lx1, solver, static="rbf", prec="highest"):
        return SignatureKernel(lam, 1.5, static=static, solver=solver,
                               mxu_precision=prec)._solver_kind(lx1, lx1)

    assert kind(3, 39, "pallas") == kind(3, 39, "auto") == "pallas"
    assert kind(3, 39, "auto", "linear") == "pallas"
    assert kind(0, 39, "pallas_small") == kind(0, 39, "auto") == "small"
    assert kind(3, 39, "mxu") == kind(0, 2, "mxu") == "mxu"
    assert kind(6, 2, "mxu_pallas") == "mxu_chain"       # any mxu_precision
    assert kind(6, 17, "mxu_pallas") == "mxu"            # beyond K8's 64 hops
    for lam, lx1, solver, static in ((3, 39, "wavefront", "rbf"),
                                     (0, 39, "pallas", "rbf"),
                                     (0, 39, "auto", "linear"),
                                     (3, 39, "pallas_small", "rbf"),
                                     (6, 2, "pallas", "rbf")):
        assert kind(lam, lx1, solver, static) == "wavefront"
    assert torch.equal(SignatureKernel(3, 1.0, solver="wavefront").gram(
        torch.zeros(2, 5, 2), torch.zeros(2, 5, 2)), torch.ones(2, 2))
    for field, value in (("solver", "scan"), ("static", "poly")):
        with pytest.raises(ValueError, match=field):
            SignatureKernel(3, **{field: value})


def test_linear_pinned_controller_reaches_k5(monkeypatch):
    """``build_arm_mpc(static="linear")`` with a calibration builds (its
    order 0 takes the wavefront); pinned at order 3 its Gram and adjoint run
    K5's twin: one forward and one backward for the 21 upper-triangle pairs
    of 6 policies' 8-point paths."""
    calibrated = build_arm_mpc(device="cpu", n_pol=6, hz_len=8, static="linear")
    assert calibrated.ctrl.sig_kernel.dyadic_order == (
        0 if calibrated.calibration_bound <= 1e-3 else 3)
    calls = []
    for name in ("tiled_forward_plain", "tiled_backward_plain"):
        plain = getattr(kt, name)
        monkeypatch.setattr(kt, name, lambda *a, _p=plain, _n=name: calls.append(
            (_n, a[0].shape)) or _p(*a))
    prob = build_arm_mpc(device="cpu", n_pol=6, hz_len=8, calibrate=False,
                         static="linear")
    assert prob.ctrl.sig_kernel.static == "linear"
    pol = torch.rand((6, 8, 7), generator=torch.Generator().manual_seed(0)) * 4.0 - 2.0
    k_xx, grad_k = prob.ctrl._kernel_terms(pol, prob.q_start)
    assert calls == [("tiled_forward_plain", (7, 7, 21)),     # τ [6, 8, 2]
                     ("tiled_backward_plain", (7, 7, 21))]
    assert k_xx.shape == (6, 6) and grad_k.shape == (6, 8, 7)
