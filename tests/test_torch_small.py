"""The port's λ=0 pair-list route and values-only block Gram against the JAX
package (its Pallas kernels in interpret mode), with the kernels' plain
twins in the port:

* K7's twins against ``pallas_pair_gram_small``: a padded list of 2048
  random pairs of [7, 6, 3] × [5, 9, 3] paths (the ly1 = 63 list is in
  ``test_torch_small_ly63.py``); k to rtol 3e-5 / atol 2e-5 and the
  gradients with respect to X, Y and the bandwidth, scaled by their max, to
  atol 5e-5 (``tests/test_pallas_small.py``);
* the copied predicates ``small_supported`` and ``jax_block_supported``
  against JAX's over a grid of shapes;
* K3's twin against JAX ``block_gram`` at [20, 9, 3] and, inside the JAX
  block envelope K3 now takes, at C = 6 and 8 and L·C = 128 ([19, 12, 8],
  [19, 16, 8], [21, 32, 4], [18, 21, 6]), atol 3e-5
  (``tests/test_pallas_block.py``); the route predicate K3 ∧ JAX's block
  envelope against JAX's ``block_supported`` at every L ≤ 64, C ≤ 10;
* ``gram_sym`` at λ=0 on the block route (values, no graph; [20, 9, 3],
  [19, 16, 8], [21, 24, 4]) and on K7's pair
  list ([6, 17, 8]: L·C > 128, with its gradient; K to K7's rtol 3e-5 /
  atol 2e-5), and at λ=3 on K4's pair list with its gradient (K atol 1e-4,
  dX scaled 4e-4, K4's), against JAX ``gram_sym`` on the same routes, and
  its gradient twice ``gram_and_grad``'s;
* the streamed λ=0 ``gram(X, Y)`` and its gradient under a lowered
  ``_DENSE_LIMIT``, paths of different lengths, against JAX's
  ``solver="pallas_small"``;
* λ=0 ``gram_and_grad`` at [6, 3, 7] (the block route in both packages,
  the port's K1) and at [5, 41, 4] (the K7 route in both), K atol 3e-5 and
  dX scaled 5e-5;
* K7's twin run first thing in fresh processes gives one result in each.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigsvgd_tpu.kernels import pallas_sigkernel_block as jblock
from sigsvgd_tpu.kernels import pallas_sigkernel_small as jsmall
from sigsvgd_tpu.kernels.sigkernel import SignatureKernel as JSignatureKernel
from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
from sigsvgd_tpu_torch.kernels import sigkernel_small as ks
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel


_FRESH_TWIN = """
import hashlib
import numpy as np
import torch
from sigsvgd_tpu_torch.kernels import sigkernel_small as ks
rng = np.random.default_rng(0)
xt, yt = (torch.from_numpy(np.cumsum(rng.normal(size=(40, 2, 4096)) * 0.3, axis=0)
                           .astype(np.float32)) for _ in range(2))
k, fac = ks.small_forward_plain(xt, yt, residuals=True)
print(hashlib.sha1(k.numpy().tobytes() + fac.numpy().tobytes()).hexdigest())
"""


def test_twin_gives_one_result_in_fresh_processes():
    """K7's twin on random-walk paths [40, 2, 4096] in fresh processes, as
    the first work of each: a process's first multi-threaded MKL vector-math
    call (torch's CPU ``exp``) gave one worker thread's slice about 1.5e-4
    relative error in roughly one process in six; the port makes one such
    call at import (``sigsvgd_tpu_torch/__init__.py``), so every process
    agrees, here eight of them, one after another (run side by side, their
    threads would share the cores, which hides the race)."""
    root = Path(__file__).resolve().parents[1]
    digests = set()
    for _ in range(8):
        out = subprocess.run([sys.executable, "-c", _FRESH_TWIN], cwd=root, check=True,
                             capture_output=True, text=True, timeout=120).stdout
        digests.add(out.strip())
    assert len(digests) == 1, digests


def _paths(rng, n, L, C, step=0.3):
    return np.cumsum(rng.normal(size=(n, L, C)) * step, axis=1).astype(np.float32)


def _scaled_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def k7_against_jax(rng, shapes):
    """K7's twin (values and the gradients of a random-weighted sum with
    respect to X, Y and h) against ``pallas_pair_gram_small`` on 2048
    random pairs."""
    (nx, Lx, C), (ny, Ly, _) = shapes
    X = (rng.normal(size=(nx, Lx, C)) * 0.4).astype(np.float32)
    Y = (rng.normal(size=(ny, Ly, C)) * 0.4).astype(np.float32)
    P = 2048
    ix, iy = rng.integers(0, nx, P), rng.integers(0, ny, P)
    w = rng.normal(size=P).astype(np.float32)
    h = np.float32(1.7)

    def jf(x, y, hh):
        k = jsmall.pallas_pair_gram_small(x, y, jnp.asarray(ix), jnp.asarray(iy), hh)
        return jnp.sum(k * w), k

    (_, kj), gj = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(h))
    xt, yt = torch.from_numpy(X).requires_grad_(True), torch.from_numpy(Y).requires_grad_(True)
    ht = torch.tensor(h, requires_grad=True)
    k = ks.pair_gram_small(xt, yt, torch.from_numpy(ix), torch.from_numpy(iy), ht)
    g = torch.autograd.grad((k * torch.from_numpy(w)).sum(), (xt, yt, ht))
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(kj), rtol=3e-5, atol=2e-5)
    for got, want in zip(g, gj):
        _scaled_close(got.numpy(), want, 5e-5)


def test_k7_twin_matches_jax(rng):
    k7_against_jax(rng, ((7, 6, 3), (5, 9, 3)))


def test_k7_remat_gives_the_same_values_and_gradients(rng):
    """The checkpointed chunk's Function (values-only forward, the forward
    again with the residual in the backward) against the one that keeps
    ``fac``: the same twin calls, so the same numbers."""
    X = torch.from_numpy(_paths(rng, 6, 8, 2))
    ix, iy = torch.from_numpy(rng.integers(0, 6, 50)), torch.from_numpy(rng.integers(0, 6, 50))
    out = []
    for remat in (False, True):
        x = X.clone().requires_grad_(True)
        k = ks.pair_gram_small(x, X, ix, iy, 2.0, remat=remat)
        out.append((k.detach(), torch.autograd.grad(k.sum(), x)[0]))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_copied_predicates_match_jax():
    for L in (2, 3, 9, 16, 17, 32, 40, 41, 46, 47, 64, 65, 70):
        for C in range(1, 11):
            for n in (1, 2, 30):
                assert ks.small_supported(L - 1, L - 1, 0, C, "rbf", 1.0) == \
                    jsmall.small_supported(L - 1, L - 1, 0, C, "rbf", 1.0), (L, C)
                assert kb.jax_block_supported(n, L, C, 1.0) == \
                    jblock.block_supported(n, L, C, "rbf", 1.0), (n, L, C)
    assert not ks.small_supported(5, 5, 0, 2, "rbf", None)
    assert not kb.jax_block_supported(8, 5, 2, None)


def test_k3_route_predicate_is_jax_block_envelope():
    """``gram_sym`` takes K3 where ``block_values_supported`` and
    ``jax_block_supported`` both hold: exactly where the JAX package's
    ``block_supported`` sends λ=0 to its block values kernel, at every
    L ≤ 64 and C ≤ 10."""
    for L in range(2, 65):
        for C in range(1, 11):
            for n in (1, 2, 30):
                assert (kb.block_values_supported(n, L, C, 1.0)
                        and kb.jax_block_supported(n, L, C, 1.0)) == \
                    jblock.block_supported(n, L, C, "rbf", 1.0), (n, L, C)
    assert not kb.block_values_supported(8, 9, 2, None)


@pytest.mark.parametrize("n,L,C", [(20, 9, 3), (19, 12, 8), (19, 16, 8), (21, 32, 4),
                                   (18, 21, 6)])
def test_k3_twin_matches_jax_block_gram(rng, n, L, C):
    X = (rng.normal(size=(n, L, C)) * 0.3).astype(np.float32)
    K = kb.block_gram(torch.from_numpy(X), 3.0)  # CPU: the twin
    Kj = jblock.block_gram(jnp.asarray(X), jnp.asarray(3.0, jnp.float32))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), atol=3e-5)
    K1, _ = kb.block_gram_and_grad(torch.from_numpy(X), 3.0)
    np.testing.assert_array_equal(K.numpy(), K1.numpy())


def test_gram_sym_lambda0_block_route_matches_jax(rng):
    """The block route at C ≤ 3 and, since K3 takes the JAX package's block
    envelope, at C = 4..8 ([19, 16, 8]: L·C = 128; [21, 24, 4]): values
    only, against JAX's block values kernel at its test's atol 3e-5. The
    wide cases take ``tests/test_pallas_block.py``'s inputs (normal × 0.3,
    h = 3, as ``test_k3_twin_matches_jax_block_gram``): with the median
    bandwidth K reaches 76 to 300 there, where fp32 alone puts both
    packages 7e-5 to 7.5e-4 from fp64. At L = 32 both packages lie 1.6e-5
    to 3.1e-5 from fp64 on such inputs (four seeds), so they may differ by
    more than 3e-5 there."""
    for shape, h in (((20, 9, 3), None), ((19, 16, 8), 3.0), ((21, 24, 4), 3.0)):
        X = (_paths(rng, *shape, 0.2) if h is None
             else (rng.normal(size=shape) * 0.3).astype(np.float32))
        x = torch.from_numpy(X).requires_grad_(True)
        K = SignatureKernel(dyadic_order=0, bandwidth=h).gram_sym(x)
        Kj = JSignatureKernel(dyadic_order=0, bandwidth=h,
                              solver="pallas_small").gram_sym(jnp.asarray(X))
        assert not K.requires_grad, shape  # the block route returns values only
        np.testing.assert_allclose(K.numpy(), np.asarray(Kj), atol=3e-5, err_msg=str(shape))


@pytest.mark.parametrize("order,shape,solver,tol", [
    (0, (6, 17, 8), "pallas_small", (2e-5, 3e-5, 5e-5)),   # L·C > 128: K7's pair list
    (3, (5, 6, 2), "pallas", (1e-4, 0.0, 4e-4)),           # K4's pair list
], ids=["lambda0_pair_list", "lambda3"])
def test_gram_sym_pair_route_and_gradient_match_jax(rng, order, shape, solver, tol):
    X = _paths(rng, *shape, 0.15)
    jk = JSignatureKernel(dyadic_order=order, bandwidth=2.0, solver=solver)

    def jf(x):
        K = jk.gram_sym(x)
        return jnp.sum(K), K

    (_, Kj), dXj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(X))
    kern = SignatureKernel(dyadic_order=order, bandwidth=2.0)
    x = torch.from_numpy(X).requires_grad_(True)
    K = kern.gram_sym(x)
    (dX,) = torch.autograd.grad(K.sum(), x)
    K = K.detach().numpy()
    np.testing.assert_allclose(K, np.asarray(Kj), atol=tol[0], rtol=tol[1])
    np.testing.assert_array_equal(K, K.T)
    _scaled_close(dX.numpy(), dXj, tol[2])
    # twice the repulsion that gram_and_grad returns
    _, dX_half = kern.gram_and_grad(torch.from_numpy(X))
    _scaled_close(dX.numpy(), 2.0 * dX_half.numpy(), 1e-5)


def test_streamed_lambda0_gram_matches_jax(rng, monkeypatch):
    """Paths of different lengths, the bandwidth from the 256×256 block's
    median (its gradient included)."""
    X = (rng.normal(size=(5, 6, 2)) * 0.4).astype(np.float32)
    Y = (rng.normal(size=(4, 7, 2)) * 0.4).astype(np.float32)
    for cls in (SignatureKernel, JSignatureKernel):
        monkeypatch.setattr(cls, "_DENSE_LIMIT", 100)
    assert 5 * 4 * 6 * 7 > SignatureKernel._DENSE_LIMIT
    jk = JSignatureKernel(dyadic_order=0, bandwidth=None, solver="pallas_small")
    Kj, vjp = jax.vjp(lambda x: jk.gram(x, jnp.asarray(Y)), jnp.asarray(X))
    (dXj,) = vjp(jnp.ones_like(Kj))
    xt = torch.from_numpy(X).requires_grad_(True)
    K = SignatureKernel(dyadic_order=0, bandwidth=None).gram(xt, torch.from_numpy(Y))
    (dX,) = torch.autograd.grad(K.sum(), xt)
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(Kj), rtol=3e-5, atol=2e-5)
    _scaled_close(dX.numpy(), dXj, 5e-5)


@pytest.mark.parametrize("shape", [(6, 3, 7), (5, 41, 4)], ids=["c7_block", "lc164_k7"])
def test_lambda0_gram_and_grad_matches_jax(rng, shape, monkeypatch):
    """[6, 3, 7] is inside JAX's block envelope (C ≤ 8, L·C ≤ 128), where
    the JAX package runs its block kernel, and K1's: the port takes K1 (its
    twin here), and no pair list. [5, 41, 4] is outside both block
    envelopes: both packages take the pair list, the port's through K7 (its
    twin here). K is held at the
    tolerance of the JAX package's own K7 test (``test_pallas_small.py``:
    rtol 3e-5, atol 2e-5), against JAX and, each of them, against the port's
    route in fp64: at [5, 41, 4] K reaches 14.6, where fp32 rounds to ~1e-6
    and the two packages' K lie ~3e-5 from fp64 on opposite sides."""
    X = _paths(rng, *shape, 0.15)
    calls, block_calls = [], []
    plain = ks.small_backward_plain
    monkeypatch.setattr(ks, "small_backward_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    block_plain = kb.block_gram_and_grad_plain
    monkeypatch.setattr(kb, "block_gram_and_grad_plain",
                        lambda X, h, **kw: block_calls.append(X.shape) or block_plain(X, h, **kw))
    kern = SignatureKernel(dyadic_order=0, bandwidth=2.0)
    K, dX = kern.gram_and_grad(torch.from_numpy(X))
    Kj, dXj = JSignatureKernel(dyadic_order=0, bandwidth=2.0,
                               solver="pallas_small").gram_and_grad(jnp.asarray(X))
    n = shape[0]
    if shape[1] * shape[2] <= 128:                            # K1, one call
        assert calls == [] and block_calls == [shape]
    else:                                                     # one chunk through K7
        assert calls == [(shape[1], shape[2], n * (n + 1) // 2)] and block_calls == []
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=3e-5, atol=2e-5)
    K64 = kern.gram_and_grad(torch.from_numpy(X).double())[0].numpy()
    for got in (K.numpy(), np.asarray(Kj)):
        np.testing.assert_allclose(got, K64, rtol=3e-5, atol=2e-5)
    np.testing.assert_array_equal(K.numpy(), K.numpy().T)
    _scaled_close(dX.numpy(), dXj, 5e-5)


def test_lambda0_outside_the_pair_list_raises(rng):
    """Outside K7's envelope (C > 8, ly1 > 63) both packages take the
    wavefront: K against JAX's at the JAX K7 test's rtol 3e-5 / atol 2e-5,
    dX scaled 5e-5."""
    for shape in ((3, 5, 9), (3, 65, 2)):
        X = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        kern = SignatureKernel(dyadic_order=0, bandwidth=1.0)
        jk = JSignatureKernel(dyadic_order=0, bandwidth=1.0, solver="pallas_small")
        K, dX = kern.gram_and_grad(torch.from_numpy(X))
        Kj, dXj = jk.gram_and_grad(jnp.asarray(X))
        np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=3e-5, atol=2e-5)
        _scaled_close(dX.numpy(), np.asarray(dXj), 5e-5)
        np.testing.assert_allclose(kern.gram_sym(torch.from_numpy(X)).numpy(),
                                   np.asarray(Kj), rtol=3e-5, atol=2e-5)
