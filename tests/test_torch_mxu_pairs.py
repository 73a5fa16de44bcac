"""The block propagator's pair lists against the JAX package.

Above ``_DENSE_LIMIT`` the streamed ``gram(X, Y)`` solves pair chunks, and
above the dense route's memory guard ``gram_and_grad`` takes the gathered
upper-triangle pair list. Both are held on planning knot paths ``[n, 3,
7]`` at λ=6 under a ``_DENSE_LIMIT`` lowered on both classes (as
``tests/test_torch_planning.py`` lowers it), with K8's twin against JAX's
``solver="mxu_pallas"`` (the Pallas kernel in interpret mode; scaled atol
1e-3 for K and 2e-3 for gradients, ``tests/test_torch_mxu_chain.py``) and
with the fp32 block propagator against ``solver="mxu"`` at
``precision="highest"`` (scaled 1e-5 and 1e-4). The chunking itself is
checked by a small CPU budget that cuts the list into several chunks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import SignatureKernel as JSignatureKernel
from sigsvgd_tpu_torch.kernels import sigkernel as sk
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel, mxu_pair_bytes

# (port solver, JAX solver, K tolerance, gradient tolerance)
ROUTES = {
    "mxu_chain": ("mxu_pallas", "mxu_pallas", 1e-3, 2e-3),
    "mxu": ("mxu", "mxu", 1e-5, 1e-4),
}


def _scaled_close(got, want, atol):
    s = np.abs(want).max()
    np.testing.assert_allclose(got / s, want / s, atol=atol)


def _kernels(kind, bandwidth):
    solver, jsolver, _, _ = ROUTES[kind]
    port = SignatureKernel(dyadic_order=6, bandwidth=bandwidth, solver=solver)
    jk = JSignatureKernel(dyadic_order=6, bandwidth=bandwidth, solver=jsolver,
                          mxu_precision="highest")
    return port, jk


@pytest.fixture
def lowered(monkeypatch):
    for cls in (SignatureKernel, JSignatureKernel):
        monkeypatch.setattr(cls, "_DENSE_LIMIT", 100)


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_streamed_gram_matches_jax(kind, lowered, rng):
    X = rng.uniform(-1.0, 1.0, size=(6, 3, 7)).astype(np.float32)
    Y = rng.uniform(-1.0, 1.0, size=(5, 3, 7)).astype(np.float32)
    port, jk = _kernels(kind, None)
    assert port._chunk_plan(2, 2, 30, 7, torch.device("cpu"), 1.0)[0] == kind
    Kj, vjp = jax.vjp(lambda x: jk.gram(x, jnp.asarray(Y)), jnp.asarray(X))
    (dXj,) = vjp(jnp.ones_like(Kj))
    x = torch.from_numpy(X).requires_grad_(True)
    K = port.gram(x, torch.from_numpy(Y))
    (dX,) = torch.autograd.grad(K.sum(), x)
    _, _, tk, tg = ROUTES[kind]
    _scaled_close(K.detach().numpy(), np.asarray(Kj), tk)
    _scaled_close(dX.numpy(), np.asarray(dXj), tg)


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_gram_and_grad_above_the_guard_matches_jax(kind, lowered, rng):
    X = rng.uniform(-1.0, 1.0, size=(7, 3, 7)).astype(np.float32)
    port, jk = _kernels(kind, 2.0)
    assert not port._dense_grad_ok(7, 2)
    Kj, dXj = jk.gram_and_grad(jnp.asarray(X))
    K, dX = port.gram_and_grad(torch.from_numpy(X))
    _, _, tk, tg = ROUTES[kind]
    _scaled_close(K.numpy(), np.asarray(Kj), tk)
    _scaled_close(dX.numpy(), np.asarray(dXj), tg)
    np.testing.assert_array_equal(K.numpy(), K.numpy().T)


def test_pair_list_chunks_agree_with_one_chunk(lowered, rng, monkeypatch):
    """A budget of a few pairs cuts the triangle list of 28 pairs into
    several chunks; K and dX equal the one-chunk result to fp32 summation
    order, and the chunk count follows :func:`mxu_pair_bytes`."""
    X = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(7, 3, 7)).astype(np.float32))
    port, _ = _kernels("mxu_chain", 2.0)
    K1, dX1 = port.gram_and_grad(X)
    per = mxu_pair_bytes("mxu_chain", 2, 2, 6, 7)
    monkeypatch.setattr(sk, "_budget_bytes", lambda device: 5 * per)
    kind, chunk, nb = port._chunk_plan(2, 2, 28, 7, X.device, 2.0)
    assert (kind, chunk, nb) == ("mxu_chain", 5, 6)
    K2, dX2 = port.gram_and_grad(X)
    np.testing.assert_allclose(K2.numpy(), K1.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dX2.numpy(), dX1.numpy(), rtol=1e-5, atol=1e-6)
