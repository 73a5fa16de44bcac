"""The port's kernels on the card, each held against its plain twin:

* K1 (λ=0 Gram + adjoint): K atol 3e-5, dX scaled by max|dX| atol 5e-5,
  the tolerances of ``tests/test_pallas_block.py``;
* K2 (λ=3 Gram + adjoint): K atol 1e-4, dX scaled atol 4e-4 (against the
  twin in fp64), those of ``tests/test_pallas_block3.py``;
* K9 (fused RBF Stein velocity): rtol 2e-4, atol 5e-5, those of
  ``tests/test_pallas_svgd.py``;
* K8 (the order ≥ 6 hop chain, forward and backward): K and dz scaled by
  their max, atol 1e-3 and 2e-3 (twin and kernel round to bf16 in the same
  places, but a hop input that differs in its last fp32 bit can round to
  another bf16).

These tests need a CUDA card and skip without one. The file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from sigsvgd_tpu_torch.kernels import mxu_chain as mc
from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
from sigsvgd_tpu_torch.kernels import sigkernel_block3 as kb3
from sigsvgd_tpu_torch.kernels import svgd_velocity as kv
from sigsvgd_tpu_torch.kernels.sigkernel import (
    SignatureKernel, _pair_sq_dists, gram_increments,
)
from sigsvgd_tpu_torch.utils.math import bw_median, pw_dist_sq


def _assert_k_dx(K, dX, Kp, dXp, k_atol=3e-5, dx_atol=5e-5):
    torch.testing.assert_close(K, Kp, atol=k_atol, rtol=0)
    scale = dXp.abs().max()
    torch.testing.assert_close(dX / scale, dXp / scale, atol=dx_atol, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA kernels "
                    "with no CPU mode")
    return torch.device("cuda")


def _paths(device, n, L, C, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.cumsum((torch.rand((n, L, C), generator=g, device=device) - 0.5) * 0.2,
                        dim=1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 40, 2), (333, 40, 2), (33, 21, 3), (7, 5, 3),
                                   (40, 64, 3)])
def test_k1_matches_plain_twin_on_the_card(cuda_device, n, L, C):
    X = _paths(cuda_device, n, L, C)
    before = kb.block_gram_and_grad.launches
    K, dX = kb.block_gram_and_grad(X, 4.0)
    assert kb.block_gram_and_grad.launches == before + 1
    Kp, dXp = kb.block_gram_and_grad_plain(X, 4.0)
    _assert_k_dx(K.cpu(), dX.cpu(), Kp.cpu(), dXp.cpu())


@pytest.mark.cuda
def test_k1_raises_outside_its_envelope(cuda_device):
    with pytest.raises(NotImplementedError, match="K7"):
        kb.block_gram_and_grad(torch.zeros(8, 65, 2, device=cuda_device), 4.0)
    with pytest.raises(NotImplementedError, match="M6"):
        SignatureKernel(dyadic_order=2, bandwidth=4.0).gram_and_grad(
            torch.zeros(8, 40, 2, device=cuda_device))
    with pytest.raises(NotImplementedError, match="K4"):
        SignatureKernel(dyadic_order=3, bandwidth=4.0).gram_and_grad(
            torch.zeros(8, 65, 2, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(40, 9, 2), (37, 13, 2), (7, 5, 3), (20, 40, 2),
                                   (2, 49, 3), (19, 30, 1), (6, 64, 3)])
def test_k2_matches_plain_twin_on_the_card(cuda_device, n, L, C):
    X = _paths(cuda_device, n, L, C)
    before = kb3.block3_gram_and_grad.launches
    K, dX = kb3.block3_gram_and_grad(X, 4.0)
    assert kb3.block3_gram_and_grad.launches == before + 1
    Kp, _ = kb3.block3_gram_and_grad_plain(X, 4.0)
    # dX against the twin in fp64: the fp32 twin's own dX may sit ~4e-4
    # (scaled) from it at λ=3
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 4.0)
    _assert_k_dx(K.cpu(), dX.double().cpu(), Kp.cpu(), dX64.cpu(), 1e-4, 4e-4)
    torch.testing.assert_close(kb3.block3_gram_plain(X, 4.0).cpu(), Kp.cpu(),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 9, 2), (777, 13, 3)])
def test_k2_blocks_taking_many_tiles_match_plain_twin(cuda_device, n, L, C):
    """More tiles than resident blocks: each persistent block reuses its
    scratch and shared slots from one tile to the next. The twin takes the
    pairs a chunk at a time to bound its memory."""
    X = _paths(cuda_device, n, L, C)
    tiles, blocks = kb3.block3_grid(n, L, C, cuda_device)
    assert tiles.shape[0] > 2 * blocks
    K, dX = kb3.block3_gram_and_grad(X, 4.0)
    Kp = kb3.block3_gram_plain(X, 4.0)
    _, dX64 = kb3.block3_gram_and_grad_plain(X.double(), 4.0, pairs_per_chunk=16384)
    _assert_k_dx(K.cpu(), dX.double().cpu(), Kp.cpu(), dX64.cpu(), 1e-4, 4e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(1024, 280), (333, 280), (50, 17), (40, 400),
                                 (64, 700)])
def test_k9_matches_plain_twin_on_the_card(cuda_device, N, D):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.rand((N, D), generator=g, device=cuda_device) * 4.0 - 2.0
    s = torch.randn((N, D), generator=g, device=cuda_device)
    h = bw_median(pw_dist_sq(x, x))  # the sampler's bandwidth
    before = kv.fused_rbf_velocity.launches
    phi = kv.fused_rbf_velocity(x, s, h)
    assert kv.fused_rbf_velocity.launches == before + 1
    want = kv.rbf_velocity_plain(x, s, h)
    torch.testing.assert_close(phi.cpu(), want.cpu(), rtol=2e-4, atol=5e-5)


def _knot_increments(device, n, lam_paths=3, seed=0):
    """Increments of the planning Gram: ``n`` knot paths [n, 3, 7] uniform
    in ±2.5 rad, RBF statics at h = 1.5 → ``[n², 2, 2]``."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = (torch.rand((n, lam_paths, 7), generator=g, device=device) - 0.5) * 5.0
    inc = gram_increments(torch.exp(-_pair_sq_dists(X, X) / 1.5))
    return inc.reshape(n * n, lam_paths - 1, lam_paths - 1).contiguous()


def _clipped_normal(device, b, lx1, ly1, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, lx1, ly1), generator=g, device=device).clamp(-2, 2)


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["planning_131072x2x2_l6", "ragged_389x4x4_l6",
                                  "sub2_1000x2x2_l7"])
def test_k8_matches_plain_twin_on_the_card(cuda_device, case):
    if case.startswith("planning"):
        inc, lam = _knot_increments(cuda_device, 363)[:131072], 6
    elif case.startswith("ragged"):
        inc, lam = _clipped_normal(cuda_device, 389, 4, 4), 6
    else:
        inc, lam = _clipped_normal(cuda_device, 1000, 2, 2), 7
    g = torch.randn(inc.shape[0], generator=torch.Generator(device=cuda_device)
                    .manual_seed(5), device=cuda_device)
    before = (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches)
    t = inc.clone().requires_grad_(True)
    k = mc.solve_goursat_pde_mxu_chain(t, lam)
    (d,) = torch.autograd.grad(k, t, g)
    assert (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tp = inc.clone().requires_grad_(True)
    kp = mc.solve_goursat_pde_mxu_chain_plain(tp, lam)
    (dp,) = torch.autograd.grad(kp, tp, g)
    assert torch.isfinite(k).all() and torch.isfinite(d).all()
    assert _scaled(k, kp) <= 1e-3
    assert _scaled(d, dp) <= 2e-3


@pytest.mark.cuda
def test_k8_raises_outside_its_envelope(cuda_device):
    with pytest.raises(ValueError, match="block hops"):
        mc.solve_goursat_pde_mxu_chain(torch.zeros(4, 9, 9, device=cuda_device), 6)
    with pytest.raises(ValueError, match="dyadic_order"):
        mc.solve_goursat_pde_mxu_chain(torch.zeros(4, 2, 2, device=cuda_device), 5)
    with pytest.raises(ValueError, match="hops"):
        mc.mxu_chain_fwd(torch.zeros(4, 81, device=cuda_device), 9, 9, 1, 9)


@pytest.mark.cuda
def test_k8_launches_once_each_per_gram_and_grad(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    X = (torch.rand((1024, 3, 7), generator=g, device=cuda_device) - 0.5) * 5.0
    before = (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches)
    K, dX = SignatureKernel(6, 1.5, mxu_precision="default").gram_and_grad(X)
    torch.cuda.synchronize()
    assert (mc.mxu_chain_fwd.launches, mc.mxu_chain_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert K.shape == (1024, 1024) and dX.shape == (1024, 3, 7)
    assert torch.isfinite(K).all() and torch.isfinite(dX).all()
